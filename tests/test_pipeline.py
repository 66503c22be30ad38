"""Downstream pipelines: FIR design, polyphase channelizer, FM demod, SDR
chain (single-device and sharded on the virtual 8-device mesh)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win.dist.mesh import make_mesh
from blackman_harris_win.pipeline.channelizer import (
    design_prototype,
    polyphase_channelize,
)
from blackman_harris_win.pipeline.demod import (
    fm_demod_conj,
    fm_demod_phase,
    phase_wrap,
)
from blackman_harris_win.pipeline.fir import (
    decimating_fir,
    design_lowpass,
    make_sharded_decimating_fir,
)
from blackman_harris_win.pipeline.sdr import make_sharded_sdr_chain, sdr_chain
from blackman_harris_win.pipeline import fir


class TestFirDesign:
    def test_dc_gain_and_stopband(self):
        h = design_lowpass(255, 0.2, window="bh4")
        assert abs(h.sum() - 1.0) < 1e-12
        f = np.fft.rfftfreq(8192)
        H = np.abs(np.fft.rfft(h, 8192))
        stop = H[f > 0.2 * 0.5 * 1.5]  # past 1.5x cutoff (freq in cycles/sample)
        assert 20 * np.log10(stop.max()) < -80  # BH-4-windowed sinc

    def test_window_choice_matters(self):
        h_hann = design_lowpass(127, 0.25, window="hann")
        h_bh7 = design_lowpass(127, 0.25, window="bh7", data_width=30)
        H = lambda h: np.abs(np.fft.rfft(h, 4096))
        f = np.fft.rfftfreq(4096)
        sb = f > 0.25
        att = lambda h: 20 * np.log10(H(h)[sb].max())
        assert att(h_bh7) < att(h_hann) - 20

    def test_bad_cutoff(self):
        with pytest.raises(ValueError):
            design_lowpass(64, 1.5)


class TestDecimatingFir:
    @pytest.mark.parametrize("decim", [1, 2, 4])
    def test_matches_numpy(self, decim):
        rng = np.random.default_rng(0)
        x = rng.normal(size=300).astype(np.float32)
        h = design_lowpass(33, 0.4).astype(np.float32)
        y = np.asarray(decimating_fir(x, h, decim))
        want = np.array(
            [np.dot(h, x[m * decim : m * decim + 33]) for m in range(len(y))]
        )
        np.testing.assert_allclose(y, want, rtol=2e-4, atol=1e-5)

    def test_batched(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 256)).astype(np.float32)
        h = design_lowpass(17, 0.3).astype(np.float32)
        y = np.asarray(decimating_fir(x, h, 2))
        for c in range(3):
            np.testing.assert_allclose(
                y[c], np.asarray(decimating_fir(x[c], h, 2)), rtol=1e-5
            )

    def test_sharded_matches_circular_reference(self):
        mesh = make_mesh(blocks=4, channels=2)
        h = design_lowpass(16, 0.4).astype(np.float32)
        decim = 4
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 4 * 64)).astype(np.float32)
        fn = jax.jit(make_sharded_decimating_fir(mesh, h, decim))
        xs = jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks"))
        )
        got = np.asarray(fn(xs))
        # documented semantics: y[m] = sum_t h[t] x[(m*D - (T-D) + t) mod T]
        T = x.shape[-1]
        halo = len(h) - decim
        want = np.zeros((2, T // decim), np.float64)
        for c in range(2):
            for m in range(T // decim):
                idx = (m * decim - halo + np.arange(len(h))) % T
                want[c, m] = np.dot(h, x[c, idx])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


class TestDecimatingFirPaths:
    """The frames-matmul and strided-conv forms agree, the frames-path cap
    counts every leading row, and both contractions ask for HIGHEST
    precision (float32 products must not run as TF32)."""

    def _jaxpr(self, x, taps, decim):
        import jax

        return str(jax.make_jaxpr(
            lambda v: fir.decimating_fir(v, taps, decim))(x))

    def test_conv_path_above_cap_equals_frames_path(self, monkeypatch):
        rng = np.random.default_rng(11)
        x = jnp.asarray(rng.standard_normal((2, 3, 4096)), jnp.float32)
        taps = rng.standard_normal(32)
        frames = np.asarray(fir.decimating_fir(x, taps, 4), np.float64)
        assert "conv_general_dilated" not in self._jaxpr(x, taps, 4)
        monkeypatch.setattr(fir, "FRAMES_CAP", 1)
        assert "conv_general_dilated" in self._jaxpr(x, taps, 4)
        conv = np.asarray(fir.decimating_fir(x, taps, 4), np.float64)
        assert conv.shape == frames.shape == (2, 3, (4096 - 32) // 4 + 1)
        xs = np.asarray(x, np.float64)
        ref = np.stack([[np.correlate(r, taps, "valid")[::4] for r in b]
                        for b in xs])
        tol = 8 * 32 * 2.0**-24 * np.max(np.abs(ref))
        assert np.max(np.abs(conv - ref)) < tol
        assert np.max(np.abs(frames - ref)) < tol

    def test_cap_counts_leading_rows(self, monkeypatch):
        x = jnp.zeros((4, 1024), jnp.float32)
        taps = np.ones(16)
        per_row = ((1024 - 16) // 4 + 1) * 16
        monkeypatch.setattr(fir, "FRAMES_CAP", 2 * per_row)
        assert "conv_general_dilated" in self._jaxpr(x, taps, 4)  # 4 rows
        assert "conv_general_dilated" not in self._jaxpr(x[:2], taps, 4)
        for path_x in (x, x[:2]):
            assert "HIGHEST" in self._jaxpr(path_x, taps, 4)


class TestChannelizer:
    def test_tone_lands_in_its_channel(self):
        C, tpb = 8, 12
        proto = design_prototype(C, tpb)
        T = C * 256
        n = np.arange(T)
        for k0 in (0, 1, 3, 7):
            x = np.exp(2j * math.pi * k0 * n / C)  # channel-center tone
            y = np.asarray(polyphase_channelize(x, proto, C))
            p = np.mean(np.abs(y) ** 2, axis=0)
            p = p / p.max()
            assert p.argmax() == k0
            others = np.delete(p, k0)
            assert 10 * np.log10(others.max() + 1e-30) < -60, (k0, others)

    def test_real_input_and_shapes(self):
        C, tpb = 4, 8
        proto = design_prototype(C, tpb)
        x = np.random.default_rng(3).normal(size=C * 64)
        y = np.asarray(polyphase_channelize(x, proto, C))
        assert y.shape == (64 - (tpb - 1), C)

    def test_bad_lengths(self):
        proto = design_prototype(4, 8)
        with pytest.raises(ValueError):
            polyphase_channelize(np.zeros(33), proto, 4)
        with pytest.raises(ValueError):
            polyphase_channelize(np.zeros(32), proto[:-1], 4)


class TestDemod:
    def test_phase_wrap(self):
        aw = 16
        assert int(phase_wrap(jnp.asarray([1 << 15]), aw)[0]) == -(1 << 15)
        assert int(phase_wrap(jnp.asarray([(1 << 15) - 1]), aw)[0]) == (1 << 15) - 1
        assert int(phase_wrap(jnp.asarray([-(1 << 15) - 1]), aw)[0]) == (1 << 15) - 1

    @pytest.mark.parametrize("fn", [fm_demod_phase, fm_demod_conj])
    def test_fm_tone_recovery(self, fn):
        aw = 20
        fs = 1.0
        n = np.arange(4096)
        fm = 0.003  # modulating tone
        fdev = 0.02
        inst_f = 0.1 + fdev * np.sin(2 * math.pi * fm * n)
        ph = 2 * math.pi * np.cumsum(inst_f)
        amp = 30000
        i = np.round(amp * np.cos(ph)).astype(np.int64)
        q = np.round(amp * np.sin(ph)).astype(np.int64)
        d = np.asarray(fn(i, q, 17, aw), np.float64)
        f_est = d / (1 << aw)
        err = np.abs(f_est - inst_f[1:])
        assert err.mean() < 5e-4, err.mean()
        # recover the modulating tone frequency
        spec = np.abs(np.fft.rfft(f_est - f_est.mean()))
        fpk = np.fft.rfftfreq(len(f_est))[spec.argmax()]
        assert abs(fpk - fm) < 2e-4


class TestSdrChain:
    def test_channel_frequency_recovery(self):
        C, tpb = 4, 8
        proto = design_prototype(C, tpb)
        T = C * 512
        n = np.arange(T)
        # tone offset +0.01 cycles/sample inside channel 1
        x = np.cos(2 * math.pi * (1 / C + 0.01) * n)
        out = np.asarray(sdr_chain(x, proto, C, angle_width=20), np.float64)
        # channel 1's discriminator: offset 0.01 * C (channel rate) cycles
        f1 = out[:, 1].mean() / (1 << 20)
        assert abs(f1 - 0.01 * C) < 2e-3, f1

    def test_sharded_matches_circular_reference(self):
        C, tpb, blocks = 4, 6, 4
        mesh = make_mesh(blocks=blocks, channels=2)
        T = blocks * C * 32
        n = np.arange(T)
        x = (np.cos(2 * math.pi * (1 / C + 0.005) * n)
             + 0.5 * np.cos(2 * math.pi * 0.07 * n)).astype(np.float32)
        fn = jax.jit(make_sharded_sdr_chain(mesh, C, tpb, angle_width=20))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("blocks")))
        got = np.asarray(fn(xs))
        assert got.shape == (T // C, C)

        # circular global reference of the documented semantics
        proto = design_prototype(C, tpb)
        h = np.asarray(proto).reshape(tpb, C)
        nf = T // C
        xp = x.reshape(nf, C)
        y = np.zeros((nf, C), np.complex128)
        for m in range(nf):
            acc = np.zeros(C)
            for t in range(tpb):
                acc = acc + h[t] * xp[(m - t) % nf]
            y[m] = np.fft.fft(acc)
        i = np.round(y.real * 2.0**14).astype(np.int64)
        q = np.round(y.imag * 2.0**14).astype(np.int64)

        # spot-check frames in the interior of shard 2 against the same
        # discriminator applied to the circular-reference frames
        start = 2 * (nf // blocks) + tpb + 1
        for m in range(start, start + 5):
            want = np.asarray(
                fm_demod_conj(i[[m - 1, m]].T, q[[m - 1, m]].T, 16, 20)
            )[:, 0]
            np.testing.assert_array_equal(got[m], want)
