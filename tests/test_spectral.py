"""Welch analyzer pipeline: unit + sharded==single-device equality tests.

Round-1 VERDICT item 2: the flagship pipeline (``pipeline/spectral.py``)
gets direct coverage — ``frames_view`` (both assembly paths),
``welch_power`` vs a naive numpy loop, ``make_sharded_welch`` vs the
single-device analyzer on the same global input (8-device mesh), and
``dryrun_multichip`` smoke for n = 1, 2, 4, 8 (SURVEY.md §4: sharded ==
single-device, asserted numerically).
"""

import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.dist.generate import sharded_window
from blackman_harris_win.dist.mesh import make_mesh
from blackman_harris_win.kernels.window import window_samples
from blackman_harris_win.pipeline.spectral import (
    frames_view,
    make_sharded_welch,
    welch_power,
    window_scale,
    windowed_power_spectrum,
)
from blackman_harris_win.windows import catalog

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _naive_frames(x, nfft, hop):
    nf = (x.shape[-1] - nfft) // hop + 1
    return np.stack([x[..., m * hop : m * hop + nfft] for m in range(nf)], axis=-2)


class TestFramesView:
    @pytest.mark.parametrize("nfft,hop,t", [(8, 4, 32), (8, 2, 20), (16, 16, 64)])
    def test_slicing_path(self, nfft, hop, t):
        # hop | nfft and hop | t: the shifted-reshape (pure slicing) path
        x = np.arange(2 * t, dtype=np.float32).reshape(2, t)
        got = np.asarray(frames_view(jnp.asarray(x), nfft, hop))
        np.testing.assert_array_equal(got, _naive_frames(x, nfft, hop))

    @pytest.mark.parametrize("nfft,hop,t", [(9, 4, 33), (8, 3, 29), (10, 4, 30)])
    def test_gather_fallback(self, nfft, hop, t):
        x = np.arange(t, dtype=np.float32)
        got = np.asarray(frames_view(jnp.asarray(x), nfft, hop))
        np.testing.assert_array_equal(got, _naive_frames(x, nfft, hop))

    def test_batch_dims(self):
        x = np.random.default_rng(0).normal(size=(2, 3, 40)).astype(np.float32)
        got = np.asarray(frames_view(jnp.asarray(x), 8, 4))
        np.testing.assert_array_equal(got, _naive_frames(x, 8, 4))


class TestWelchPower:
    def test_matches_naive_numpy(self):
        rng = np.random.default_rng(1)
        nfft, hop, t = 64, 32, 512
        x = rng.normal(size=(3, t)).astype(np.float32)
        win = rng.normal(size=nfft).astype(np.float32)
        got = np.asarray(welch_power(jnp.asarray(x), jnp.asarray(win), nfft, hop))
        fr = _naive_frames(x, nfft, hop) * win
        want = np.mean(np.abs(np.fft.rfft(fr, axis=-1)) ** 2, axis=-2)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)

    def test_windowed_power_spectrum_tone(self):
        # A pure tone at bin 8 must put its peak at bin 8, floor below -80 dB
        # away from it (BH-4 at 17 bits, README "1 bit = 6 dB": -92 dB).
        spec = WindowSpec(9, 17)  # nfft = 512
        t = 4096
        n = np.arange(t)
        x = np.cos(2 * np.pi * 8 / 512 * n).astype(np.float32)
        p = np.asarray(windowed_power_spectrum(jnp.asarray(x), "bh4", spec))
        pdb = 10 * np.log10(np.maximum(p / p.max(), 1e-30))
        assert int(np.argmax(pdb)) == 8
        assert pdb[40:].max() < -80.0


@pytest.mark.parametrize("channels,blocks", [(2, 4), (1, 8), (4, 2)])
class TestShardedWelchEqualsSingle:
    """make_sharded_welch == the single-device analyzer on the same global
    input.  The sharded analyzer frames the stream *circularly* (uniform
    frame counts per shard; dist/halo.right_halo), so the single-device
    reference extends x by its first nfft-hop samples."""

    def test_equality(self, channels, blocks):
        mesh = make_mesh(blocks=blocks, channels=channels)
        spec = WindowSpec(7, 17)  # nfft = 128
        nfft, hop = 128, 64
        d = catalog.get("bh4")
        q = d.quantized(17)

        c_total, t = 2 * channels, blocks * 512
        rng = np.random.default_rng(42)
        x = rng.normal(size=(c_total, t)).astype(np.float32)

        step = jax.jit(make_sharded_welch(mesh, spec, q, d.shift, nfft, hop))
        xs = jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks"))
        )
        got = np.asarray(step(xs))

        # single-device circular reference
        wq = window_samples(jnp.arange(nfft), q, spec)
        win = wq.astype(jnp.float32) * jnp.float32(window_scale(spec, d.shift))
        x_ext = jnp.concatenate([jnp.asarray(x), jnp.asarray(x[:, : nfft - hop])], -1)
        want = np.asarray(welch_power(x_ext, win, nfft, hop))

        assert got.shape == (c_total, nfft // 2 + 1)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)

    def test_float_mode_equality(self, channels, blocks):
        """win_mode='float': every shard generates the native f32 window
        (kernels/floatwin.py); must equal the single-device float-window
        analyzer on the same circular framing."""
        from blackman_harris_win.kernels.floatwin import float_window

        mesh = make_mesh(blocks=blocks, channels=channels)
        spec = WindowSpec(7, 17)
        nfft, hop = 128, 64
        d = catalog.get("bh4")

        c_total, t = 2 * channels, blocks * 512
        rng = np.random.default_rng(43)
        x = rng.normal(size=(c_total, t)).astype(np.float32)

        step = jax.jit(make_sharded_welch(
            mesh, spec, "bh4", d.shift, nfft, hop, win_mode="float"))
        xs = jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks"))
        )
        got = np.asarray(step(xs))

        win = float_window("bh4", 7)
        x_ext = jnp.concatenate(
            [jnp.asarray(x), jnp.asarray(x[:, : nfft - hop])], -1)
        want = np.asarray(welch_power(x_ext, win, nfft, hop))
        assert got.shape == (c_total, nfft // 2 + 1)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


class TestShardedWindowBitEqual:
    def test_sharded_generation_bit_equal(self):
        mesh = make_mesh(blocks=8)
        spec = WindowSpec(12, 17)
        q = catalog.get("bh7").quantized(17)
        got = np.asarray(sharded_window(q, spec, mesh))
        want = np.asarray(window_samples(np.arange(spec.n), q, spec))
        np.testing.assert_array_equal(got, want)


class TestDryrunMultichip:
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_smoke(self, n):
        import __graft_entry__ as g

        g.dryrun_multichip(n)

    def test_entry_compiles(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out, wide_sum = jax.jit(fn)(*args)
        assert out.shape[-1] == 2049
        assert bool(jnp.all(jnp.isfinite(out)))
        # the wide-datapath tile (W=32 BH-7 RTL) checksum must match the
        # golden model's sum over the same indices
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.kernels.window import rtl_cordic_coeffs
        from blackman_harris_win.model import golden
        from blackman_harris_win.windows import catalog

        q32 = rtl_cordic_coeffs(catalog.get("bh7").quantized(32))
        want = sum(
            golden.win_cosine_sum_rtl(n, q32, 26, 32) for n in range(2048)
        )
        want = ((want + (1 << 31)) % (1 << 32)) - (1 << 31)  # int32 sum wrap
        assert int(wide_sum) == want


class TestPackedFft:
    """Round-5 FFT-wall work: the two-real-frames-per-complex-FFT packing
    (welch_power fft_mode='packed') must agree with the rFFT path to f32
    accuracy in every win_mode, odd and even frame counts."""

    def _x(self, c, t, seed=0):
        return np.random.default_rng(seed).normal(size=(c, t)).astype(
            np.float32)

    @pytest.mark.parametrize("nframes", [4, 5])  # even + odd (zero-pad)
    def test_packed_matches_rfft(self, nframes):
        from blackman_harris_win.pipeline.spectral import welch_power

        nfft, hop = 256, 128
        t = hop * (nframes - 1) + nfft
        x = self._x(2, t)
        win = np.hanning(nfft).astype(np.float32)
        a = np.asarray(welch_power(x, win, nfft, hop, "rfft"), np.float64)
        b = np.asarray(welch_power(x, win, nfft, hop, "packed"), np.float64)
        rel = np.max(np.abs(a - b) / (np.abs(a) + 1e-300))
        assert rel < 1e-5, rel

    def test_packed_exact_vs_f64_host(self):
        """Both modes against the exact f64 periodogram — the packing is
        identical math, not an approximation."""
        from blackman_harris_win.pipeline.spectral import (
            frames_view, welch_power,
        )

        nfft, hop = 128, 64
        t = 8 * hop + nfft - hop
        x = self._x(1, t, seed=3)
        win = np.hanning(nfft).astype(np.float32)
        fr = np.asarray(frames_view(jnp.asarray(x), nfft, hop), np.float64)
        ref = (np.abs(np.fft.rfft(fr * win.astype(np.float64),
                                  axis=-1)) ** 2).mean(axis=-2)
        for mode in ("rfft", "packed"):
            got = np.asarray(welch_power(x, win, nfft, hop, mode),
                             np.float64)
            rel = np.max(np.abs(got - ref) / (np.abs(ref) + 1e-300))
            assert rel < 1e-5, (mode, rel)

    def test_all_win_modes_support_packed(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            windowed_power_spectrum,
        )

        spec = WindowSpec(8, 17)
        x = self._x(2, 2048, seed=5)
        for wm in ("quantized", "float", "comp"):
            a = np.asarray(windowed_power_spectrum(
                x, "bh4", spec, win_mode=wm, fft_mode="rfft"), np.float64)
            b = np.asarray(windowed_power_spectrum(
                x, "bh4", spec, win_mode=wm, fft_mode="packed"), np.float64)
            rel = np.max(np.abs(a - b) / (np.abs(a) + 1e-300))
            assert rel < 1e-5, (wm, rel)

    def test_sharded_welch_packed(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.spectral import (
            make_sharded_welch, welch_power, window_scale,
        )
        from blackman_harris_win.kernels.window import window_samples
        from blackman_harris_win.windows import catalog
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        spec = WindowSpec(7, 17)
        nfft, hop = 128, 64
        d = catalog.get("bh4")
        q = d.quantized(17)
        x = self._x(2, n_dev * 256, seed=7)
        xd = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P(None, "blocks")))
        step = jax.jit(make_sharded_welch(
            mesh, spec, q, d.shift, nfft, hop, fft_mode="packed"))
        got = np.asarray(step(xd), np.float64)
        # single-device circular-halo reference
        halo = nfft - hop
        xe = np.concatenate([x, x[:, :halo]], axis=1)
        win = np.asarray(window_samples(jnp.arange(nfft), q, spec),
                         np.float64) * window_scale(spec, d.shift)
        want = np.asarray(welch_power(
            jnp.asarray(xe), win.astype(np.float32), nfft, hop), np.float64)
        rel = np.max(np.abs(got - want) / (np.abs(want) + 1e-300))
        assert rel < 1e-5, rel

    def test_bad_fft_mode(self):
        from blackman_harris_win.pipeline.spectral import welch_power

        with pytest.raises(ValueError, match="fft_mode"):
            welch_power(np.zeros((1, 512), np.float32),
                        np.ones(128, np.float32), 128, 64, "fast")


class TestRfftPowerSplit:
    def test_matches_rfft_power(self):
        from blackman_harris_win.pipeline.spectral import rfft_power_split

        rng = np.random.default_rng(11)
        for n in (128, 4096):
            x = rng.normal(size=(3, n)).astype(np.float32)
            got = np.asarray(rfft_power_split(jnp.asarray(x)), np.float64)
            ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
            rel = np.max(np.abs(got - ref) / (ref.max() + 1e-300))
            assert rel < 2e-6, (n, rel)

    def test_odd_length_rejected(self):
        from blackman_harris_win.pipeline.spectral import rfft_power_split

        with pytest.raises(ValueError, match="even"):
            rfft_power_split(np.zeros(127, np.float32))


class TestMxuFft:
    """fft_mode='mxu': mixed-radix matmul DFT stages, the backend that
    bypasses XLA's FFT."""

    @pytest.mark.parametrize("nfft", [256, 512, 1024, 4096])
    def test_matches_rfft(self, nfft):
        from blackman_harris_win.pipeline.spectral import welch_power

        hop = nfft // 2
        t = hop * 6 + nfft - hop
        x = np.random.default_rng(2).normal(size=(2, t)).astype(np.float32)
        win = np.hanning(nfft).astype(np.float32)
        a = np.asarray(welch_power(x, win, nfft, hop, "rfft"), np.float64)
        b = np.asarray(welch_power(x, win, nfft, hop, "mxu"), np.float64)
        rel = np.max(np.abs(a - b) / (np.abs(a).max() + 1e-300))
        assert rel < 2e-6, (nfft, rel)

    def test_radix_plan(self):
        from blackman_harris_win.pipeline.spectral import _mxu_radices

        assert _mxu_radices(1 << 20) == (128, 128, 64)
        assert _mxu_radices(4096) == (64, 64)
        assert _mxu_radices(512) == (32, 16)
        for n in (256, 512, 1024, 1 << 14, 1 << 20):
            r = _mxu_radices(n)
            prod = 1
            for v in r:
                prod *= v
            assert prod == n, (n, r)

    def test_guards(self):
        from blackman_harris_win.pipeline.spectral import _mxu_radices

        with pytest.raises(ValueError, match="mxu"):
            _mxu_radices(128)
        with pytest.raises(ValueError, match="mxu"):
            _mxu_radices(3000)

    def test_through_windowed_power_spectrum(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            windowed_power_spectrum,
        )

        spec = WindowSpec(9, 17)  # nfft = 512
        x = np.random.default_rng(4).normal(size=(2, 2048)).astype(
            np.float32)
        a = np.asarray(windowed_power_spectrum(
            x, "bh4", spec, fft_mode="rfft"), np.float64)
        b = np.asarray(windowed_power_spectrum(
            x, "bh4", spec, fft_mode="mxu"), np.float64)
        rel = np.max(np.abs(a - b) / (np.abs(a).max() + 1e-300))
        assert rel < 2e-6, rel


class TestMxuCfft:
    def test_complex_fft_natural_order(self):
        from blackman_harris_win.pipeline.spectral import mxu_cfft

        rng = np.random.default_rng(9)
        for m in (256, 1024):
            z = (rng.normal(size=(2, m)) + 1j * rng.normal(size=(2, m))
                 ).astype(np.complex64)
            xr, xi = mxu_cfft(jnp.asarray(z.real), jnp.asarray(z.imag))
            got = np.asarray(xr, np.float64) + 1j * np.asarray(xi, np.float64)
            ref = np.fft.fft(z.astype(np.complex128), axis=-1)
            rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
            assert rel < 2e-6, (m, rel)

    def test_rfft_power_split_mxu(self):
        from blackman_harris_win.pipeline.spectral import rfft_power_split

        rng = np.random.default_rng(10)
        x = rng.normal(size=(2, 2048)).astype(np.float32)
        got = np.asarray(rfft_power_split(jnp.asarray(x), "mxu"), np.float64)
        ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
        rel = np.max(np.abs(got - ref) / (ref.max() + 1e-300))
        assert rel < 2e-6, rel


class TestWelchBackendsVsF64:
    """Every FFT backend against a float64 NumPy Welch: 1-D and 2-D input,
    even and odd frame counts (packed and mxu pair frames and pad an odd
    one)."""

    @pytest.mark.parametrize("mode", ["rfft", "packed", "mxu"])
    @pytest.mark.parametrize("shape", [(), (3,)])
    @pytest.mark.parametrize("nframes", [6, 7])
    def test_matches_numpy_f64(self, mode, shape, nframes):
        from blackman_harris_win.pipeline.spectral import welch_power

        nfft, hop = 256, 128
        t = (nframes - 1) * hop + nfft
        rng = np.random.default_rng(nframes + len(shape))
        x = rng.standard_normal(shape + (t,)).astype(np.float32)
        win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft))
        got = np.asarray(welch_power(jnp.asarray(x), jnp.asarray(
            win, jnp.float32), nfft, hop, mode), np.float64)
        frames = np.stack([x[..., m * hop: m * hop + nfft]
                           for m in range(nframes)], axis=-2)
        ref = np.mean(np.abs(np.fft.rfft(
            frames.astype(np.float64) * win.astype(np.float32),
            axis=-1)) ** 2, axis=-2)
        assert got.shape == shape + (nfft // 2 + 1,)
        # f32 arithmetic: ~nfft ops per bin, eps 2^-24, sqrt(nfft) growth,
        # x32 margin (the derivation of chip_smoke.welch_budget)
        budget = 32 * 2.0**-24 * np.sqrt(nfft)
        assert np.max(np.abs(got - ref) / ref) < budget

