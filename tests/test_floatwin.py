"""Float32 native window generation (kernels/floatwin.py).

The reference has no float datapath (its float model is the Octave golden,
math/window_test.m:122-138); this mode is an addition for float
consumers.  Acceptance: sample-domain error vs the float64 catalog golden,
plus the published sidelobe floors measured spectrally (the reference's
own methodology, SURVEY.md §4.3) — including the pinned finding that f32
matches the f64 floor exactly through 5-term windows and holds ~ -163 dB
(of -180) on BH-7.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from blackman_harris_win.kernels.floatwin import (
    DEFAULT_SPLIT,
    float_window,
    float_window_block,
)
from blackman_harris_win.utils.spectral import window_sidelobe_db
from blackman_harris_win.windows.catalog import float_window_value, names


class TestSampleAccuracy:
    @pytest.mark.parametrize("name", names())
    def test_matches_f64_golden(self, name):
        pw = 14
        w = np.asarray(float_window(name, pw), np.float64)
        gold = float_window_value(name, np.arange(1 << pw), 1 << pw)
        # error model: ~K * 2^-23 absolute (unit amplitude); measured max
        # across the catalog 1.9e-7 at pw=16
        assert np.max(np.abs(w - gold)) < 1.5e-6

    def test_explicit_coefficients(self):
        w = np.asarray(float_window((0.5, 0.5), 10), np.float64)
        n = np.arange(1024)
        hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / 1024)
        assert np.max(np.abs(w - hann)) < 1e-6

    def test_tiny_pw_fallback(self):
        # pw <= 1 lo-split: host f64 path
        w = np.asarray(float_window("hann", 4), np.float64)
        gold = float_window_value("hann", np.arange(16), 16)
        assert np.max(np.abs(w - gold)) < 1e-6


class TestBlocks:
    def test_blocks_tile_the_window(self):
        pw, m, rows = 14, 8, 4
        full = np.asarray(float_window("bh5", pw, m=m))
        step = rows << m
        blocks = [
            np.asarray(float_window_block(n0, rows, "bh5", pw, m=m))
            for n0 in range(0, 1 << pw, step)
        ]
        np.testing.assert_array_equal(np.concatenate(blocks), full)

    def test_traced_offset(self):
        pw = 13

        @jax.jit
        def gen(n0):
            return float_window_block(n0, 2, "bh4", pw)

        got = np.asarray(gen(jnp.int32(1 << DEFAULT_SPLIT)))
        want = np.asarray(float_window_block(1 << DEFAULT_SPLIT, 2, "bh4", pw))
        np.testing.assert_array_equal(got, want)

    def test_split_bounds(self):
        with pytest.raises(ValueError, match="split"):
            float_window_block(0, 1, "hann", 10, m=10)


class TestSpectralFloors:
    """Measured at pw=16 (oversampled FFT): f32 == f64 floor through five
    terms; BH-7 loses the last ~17 dB of its -180 dB contract to f32
    rounding (floatwin.py module docstring)."""

    @pytest.mark.parametrize("name,bound", [
        ("hamming", -43.0),
        ("hann", -31.5),
        ("blackman", -58.0),
        ("bh3", -71.0),
        ("bh4", -92.0),
        ("nuttall", -93.0),
        ("blackman_nuttall", -98.0),
        ("bh5", -124.0),
    ])
    def test_published_floor_held(self, name, bound):
        w = np.asarray(float_window(name, 16), np.float64)
        assert window_sidelobe_db(w) <= bound

    def test_bh7_floor_pinned(self):
        w = np.asarray(float_window("bh7", 16), np.float64)
        fl = window_sidelobe_db(w)
        assert fl <= -160.0  # measured -163.2 at pw=16, -167.9 at pw=20
        # and it genuinely cannot reach the int paths' -180 contract:
        assert fl > -180.0


class TestPipelineIntegration:
    def test_welch_float_mode_matches_quantized(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            windowed_power_spectrum,
        )

        spec = WindowSpec(8, 17)
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(2, 1024)).astype(np.float32))
        pq = np.asarray(windowed_power_spectrum(x, "bh4", spec))
        pf = np.asarray(
            windowed_power_spectrum(x, "bh4", spec, win_mode="float")
        )
        assert pf.shape == pq.shape
        # same window to ~17-bit quantization accuracy -> spectra agree
        np.testing.assert_allclose(pf, pq, rtol=5e-4, atol=1e-6)
        with pytest.raises(ValueError, match="win_mode"):
            windowed_power_spectrum(x, "bh4", spec, win_mode="nope")

    def test_float_mode_rejects_quantized_tuple(self):
        """ADVICE r3: flipping win_mode='float' while passing the usual
        quantized-integer coefficient tuple must raise, not silently
        generate an integer-amplitude window."""
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            make_sharded_welch,
            windowed_power_spectrum,
        )
        from blackman_harris_win.windows import catalog

        spec = WindowSpec(8, 17)
        q = catalog.get("bh4").quantized(17)
        x = jnp.zeros((1, 1024), jnp.float32)
        with pytest.raises(ValueError, match="quantized integer"):
            windowed_power_spectrum(x, q, spec, win_mode="float")
        from blackman_harris_win.dist.mesh import make_mesh

        mesh = make_mesh(blocks=1)
        with pytest.raises(ValueError, match="quantized integer"):
            make_sharded_welch(mesh, spec, q, 1, 256, 128, win_mode="float")
        # float coefficient tuples still pass through
        pf = windowed_power_spectrum(x, (0.5, 0.5), spec, win_mode="float")
        assert pf.shape == (1, 129)

    def test_sharded_float_window(self):
        from blackman_harris_win.dist.generate import sharded_float_window
        from blackman_harris_win.dist.mesh import make_mesh

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        pw = 14
        w = sharded_float_window("bh7", pw, mesh)
        got = np.asarray(w)
        assert got.shape == (1 << pw,)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        assert np.max(np.abs(got.astype(np.float64) - gold)) < 1.5e-6
        # same tables + same per-sample expression, but NOT asserted
        # bitwise: XLA may contract mul+sub into FMAs differently in the
        # shard_map program vs the single-device one (excess precision is
        # allowed), so cross-program f32 equality is to a few ULP.  The
        # *int* paths carry the bitwise sharded==single guarantee.
        block = (1 << pw) // n_dev
        m = min(DEFAULT_SPLIT, block.bit_length() - 1)
        single = np.asarray(float_window("bh7", pw, m=m))
        np.testing.assert_allclose(got, single, rtol=0, atol=2e-7)


class TestDesignedWindows:
    def test_designed_coeffs_through_float_path(self):
        """windows/design.py output feeds float_window directly: a designed
        K=4 minimax set (the -98 dB blackman_nuttall optimum) generated
        natively in f32 must hold its designed floor."""
        from blackman_harris_win.windows.design import design_min_sidelobe

        r = design_min_sidelobe(4)
        w = np.asarray(float_window(tuple(r.coeffs), 14), np.float64)
        assert window_sidelobe_db(w) <= r.sidelobe_db + 1.0  # dB, small slack


class TestFloatStftPair:
    def test_round_trip(self):
        from blackman_harris_win.pipeline.stft import float_stft_pair

        fwd, inv, win = float_stft_pair("bh4", 7, hop=32)
        assert win.dtype == jnp.float32 and win.shape == (128,)
        rng = np.random.default_rng(11)
        x = jnp.asarray(rng.normal(size=(512,)).astype(np.float32))
        y = np.asarray(inv(fwd(x), length=512))
        # WOLA with per-sample normalization reconstructs the interior
        np.testing.assert_allclose(
            y[128:-128], np.asarray(x)[128:-128], atol=1e-4
        )
