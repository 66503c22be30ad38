"""Selector front-end, spectral utils, streaming checkpoint/resume."""

import numpy as np
import pytest

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels.window import make_window, window_samples
from blackman_harris_win.utils.spectral import (
    power_spectrum_db,
    required_width_for_sidelobe,
    tone_spectral_floor_db,
    window_sidelobe_db,
)
from blackman_harris_win.utils.streaming import StreamCursor, stream_blocks
from blackman_harris_win.windows import catalog
from blackman_harris_win.windows.selector import WinSelector


class TestWinSelector:
    def test_default_matches_make_window(self):
        sel = WinSelector("BH4TERM", phi_width=10, dat_width=17)
        got = np.asarray(sel())
        want = np.asarray(
            make_window("bh4", WindowSpec(10, 17, overflow="saturate"))
        )
        np.testing.assert_array_equal(got, want)

    def test_coefficient_ports_are_data(self):
        # Nuttall through the BH4TERM core via AA ports (win_selector
        # forwards AA0..AA6 as runtime data, src/win_selector.vhd:75-81)
        aa = catalog.get("nuttall").quantized(17)
        sel = WinSelector("BH4TERM", 10, 17, aa=aa)
        got = np.asarray(sel())
        want = np.asarray(
            make_window("nuttall", WindowSpec(10, 17, overflow="saturate"))
        )
        np.testing.assert_array_equal(got, want)

    def test_taylor_only_for_2_3_term(self):
        WinSelector("HAMMING", 12, 16, sin_type="TAYLOR")  # fine
        with pytest.raises(ValueError):
            WinSelector("BH4TERM", 12, 16, sin_type="TAYLOR")

    def test_bad_win_type(self):
        with pytest.raises(ValueError):
            WinSelector("KAISER", 10, 16)

    def test_wrong_port_count(self):
        with pytest.raises(ValueError):
            WinSelector("BH3TERM", 10, 16, aa=(1, 2))

    def test_indexed_call(self):
        sel = WinSelector("HAMMING", 10, 16)
        full = np.asarray(sel())
        part = np.asarray(sel(np.arange(100, 110)))
        np.testing.assert_array_equal(part, full[100:110])


class TestSpectralUtils:
    def test_tone_floor_measures_quantization(self):
        # 16-bit quantized tone: spur floor should be way below a coarse
        # 8-bit one
        n = np.arange(4096)
        t16 = np.round(32767 * np.cos(2 * np.pi * 33 * n / 4096))
        t8 = np.round(127 * np.cos(2 * np.pi * 33 * n / 4096))
        assert tone_spectral_floor_db(t16) < tone_spectral_floor_db(t8) - 30

    def test_window_sidelobe_matches_test_suite_method(self):
        spec = WindowSpec(12, 18, overflow="saturate")
        win = np.asarray(make_window("bh4", spec))
        lvl = window_sidelobe_db(win, n_terms=4)
        assert -96 < lvl < -91  # BH-4 published -92

    def test_sizing_rule(self):
        # README.md:5-6: BH-4 at -92 dB => 17 bits
        assert required_width_for_sidelobe(-92) == 17
        assert required_width_for_sidelobe(-180) == 31

    def test_power_spectrum_db_shape(self):
        db = power_spectrum_db(np.ones(256))
        assert db.shape == (256,) and db.max() <= 0.0


class TestStreamingCheckpoint:
    def test_roundtrip(self, tmp_path):
        spec = WindowSpec(12, 17)
        cur = StreamCursor(spec, (1, 2, 3, 4), block_len=256, next_block=3)
        p = tmp_path / "cursor.json"
        cur.save(p)
        back = StreamCursor.load(p)
        assert back == cur
        assert back.next_sample == 3 * 256
        assert back.total_blocks == 16

    def test_resume_produces_identical_window(self, tmp_path):
        spec = WindowSpec(10, 17)
        q = catalog.get("bh4").quantized(17)
        cur = StreamCursor(spec, q, block_len=128)
        p = tmp_path / "c.json"
        out = np.zeros(spec.n, np.int64)

        # run 3 blocks, "crash", resume from checkpoint, finish
        it = stream_blocks(cur, p)
        for _ in range(3):
            c, n0 = next(it)
            out[n0 : n0 + 128] = np.asarray(
                window_samples(n0 + np.arange(128), q, spec)
            )
        # at-least-once: the checkpoint trails the consumed block by one;
        # re-generating that block is idempotent
        resumed = StreamCursor.load(p)
        assert resumed.next_block == 2
        for c, n0 in stream_blocks(resumed, p):
            out[n0 : n0 + 128] = np.asarray(
                window_samples(n0 + np.arange(128), q, spec)
            )
        want = np.asarray(make_window("bh4", spec))
        np.testing.assert_array_equal(out, want)
        assert StreamCursor.load(p).done


class TestSelectorRtlCorrection:
    def test_corrected_ports_restore_floor(self):
        """WinSelector(rtl_a0_correction=True) hands the halved-AA0 ports
        to the RTL core: published floor instead of the -39 dB pedestal."""
        import numpy as np

        from blackman_harris_win.utils.spectral import window_sidelobe_db
        from blackman_harris_win.windows.selector import WinSelector

        raw = WinSelector("BH4TERM", phi_width=12, dat_width=17,
                          rounding="rtl", overflow="wrap")
        fixed = WinSelector("BH4TERM", phi_width=12, dat_width=17,
                            rounding="rtl", overflow="wrap",
                            rtl_a0_correction=True)
        w_raw = np.asarray(raw(), np.float64)
        w_fix = np.asarray(fixed(), np.float64)
        assert window_sidelobe_db(w_raw) > -45.0  # the faithful pedestal
        assert window_sidelobe_db(w_fix) <= -92.0  # published BH-4 floor

    def test_correction_ignored_outside_rtl_cordic(self):
        import numpy as np

        from blackman_harris_win.windows.selector import WinSelector

        a = WinSelector("BH4TERM", phi_width=10, dat_width=17)
        b = WinSelector("BH4TERM", phi_width=10, dat_width=17,
                        rtl_a0_correction=True)
        np.testing.assert_array_equal(np.asarray(a()), np.asarray(b()))


class TestRooflineAccounting:
    """Shares are taken against one peaks table keyed by device_kind; a
    device missing from it is an error, never a default."""

    def test_h100_kind_resolves(self):
        from blackman_harris_win.utils.profiling import device_peaks

        p = device_peaks("NVIDIA H100 80GB HBM3")
        assert p["hbm_bytes_per_s"] == 3.35e12
        assert p["f32_flop_per_s"] == 67e12

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100"])
    def test_unknown_kind_raises(self, kind):
        from blackman_harris_win.utils.profiling import (
            device_peaks, roofline_fields,
        )

        with pytest.raises(KeyError, match="no published peaks"):
            device_peaks(kind)
        with pytest.raises(KeyError):
            roofline_fields(1.0, kind, bytes_moved=1)

    def test_zero_ops_fields(self):
        from blackman_harris_win.utils.profiling import roofline_fields

        f = roofline_fields(1.0, "NVIDIA H100 80GB HBM3",
                            bytes_moved=3_350_000_000)
        assert f["f32_flop_frac"] == 0.0
        assert 0.0009 < f["hbm_frac"] < 0.0011
        g = roofline_fields(2.0, "NVIDIA H100 80GB HBM3", flops=67_000_000_000)
        assert abs(g["f32_flop_frac"] - 5e-4) < 1e-12 and g["hbm_frac"] == 0.0


class TestSteadySeconds:
    def test_waits_and_reports_median(self):
        import jax.numpy as jnp

        from blackman_harris_win.utils.profiling import steady_seconds

        calls = []

        def fn(x):
            calls.append(1)
            return jnp.sum(x)

        t = steady_seconds(fn, jnp.arange(8.0), reps=3)
        assert t >= 0.0 and len(calls) == 4  # one untimed warm-up


class TestCompileCache:
    def test_env_set_is_left_alone(self, monkeypatch):
        import jax

        from blackman_harris_win.utils.compile_cache import use_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert use_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before

    def test_unset_uses_fixed_repo_path(self, monkeypatch):
        import pathlib

        import jax

        from blackman_harris_win.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = compile_cache.use_compile_cache()
            repo = pathlib.Path(__file__).resolve().parents[1]
            assert got == str(repo / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert compile_cache.use_compile_cache() == got  # fixed, not per-call
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
