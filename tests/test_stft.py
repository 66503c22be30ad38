"""STFT / WOLA synthesis (pipeline/stft.py): overlap-add vs a naive loop on
both datapaths (reshape-trick and gather), perfect reconstruction through
the quantized catalog windows, and jit cleanliness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.pipeline.spectral import frames_view, window_scale
from blackman_harris_win.pipeline.stft import (
    istft,
    overlap_add,
    quantized_stft_pair,
    stft,
)
from blackman_harris_win.windows import catalog


def naive_overlap_add(frames, hop, length=None):
    frames = np.asarray(frames)
    *lead, nf, nfft = frames.shape
    t = (nf - 1) * hop + nfft
    out = np.zeros(tuple(lead) + (length or t,), frames.dtype)
    for m in range(nf):
        out[..., m * hop : m * hop + nfft] += frames[..., m, :]
    return out


class TestOverlapAdd:
    @pytest.mark.parametrize("hop", [2, 4, 8])  # hop | nfft: reshape path
    def test_reshape_path_matches_naive(self, hop):
        fr = np.random.default_rng(0).normal(size=(5, 6, 8))
        got = overlap_add(jnp.asarray(fr), hop)
        assert np.allclose(np.asarray(got), naive_overlap_add(fr, hop))

    @pytest.mark.parametrize("hop", [3, 5, 7])  # hop does not divide nfft
    def test_gather_path_matches_naive(self, hop):
        fr = np.random.default_rng(1).normal(size=(6, 8))
        got = overlap_add(jnp.asarray(fr), hop)
        assert np.allclose(np.asarray(got), naive_overlap_add(fr, hop))

    def test_batched_leading_dims(self):
        fr = np.random.default_rng(2).normal(size=(2, 3, 4, 8))
        got = overlap_add(jnp.asarray(fr), 4)
        assert got.shape == (2, 3, 3 * 4 + 8)
        assert np.allclose(np.asarray(got), naive_overlap_add(fr, 4))

    def test_explicit_length_pads(self):
        fr = np.ones((2, 8))
        got = overlap_add(jnp.asarray(fr), 4, length=20)
        assert got.shape == (20,)
        assert np.allclose(np.asarray(got), naive_overlap_add(fr, 4, 20))

    def test_length_too_short_raises(self):
        with pytest.raises(ValueError, match="overlap-add extent"):
            overlap_add(jnp.ones((2, 8)), 4, length=10)

    def test_adjoint_of_frames_view(self):
        """overlap_add(frames_view(x)) = x * (per-sample frame count) — the
        defining adjoint relation (rect-window WOLA denominator)."""
        t, nfft, hop = 32, 8, 4
        x = jnp.asarray(np.random.default_rng(3).normal(size=t))
        ola = overlap_add(frames_view(x, nfft, hop), hop)
        cnt = naive_overlap_add(np.ones(((t - nfft) // hop + 1, nfft)), hop)
        assert np.allclose(np.asarray(ola), np.asarray(x) * cnt)


class TestRoundTrip:
    @pytest.mark.parametrize("name", ["hann", "bh4", "bh7"])
    @pytest.mark.parametrize("div", [2, 4])
    def test_quantized_window_reconstruction(self, name, div):
        """Perfect reconstruction through the reference-quantized window at
        50% and 75% overlap — including the non-COLA >=3-term windows (the
        per-sample WOLA normalization at work)."""
        spec = WindowSpec(phase_width=8, data_width=17)
        nfft, hop = spec.n, spec.n // div
        fwd, inv, win = quantized_stft_pair(name, spec, hop)
        t = nfft + 13 * hop
        x = jnp.asarray(
            np.random.default_rng(4).normal(size=t).astype(np.float32)
        )
        y = inv(fwd(x))
        # interior (fully-overlapped) samples; the first/last nfft samples
        # see fewer frames and a near-zero window edge can make their
        # normalization ill-conditioned (istft docstring)
        assert np.allclose(
            np.asarray(y)[nfft:-nfft], np.asarray(x)[nfft:-nfft], atol=1e-5
        )

    def test_gather_path_round_trip(self):
        """hop ∤ nfft exercises the gather framing + scatter overlap-add."""
        nfft, hop = 16, 6
        win = jnp.asarray(
            catalog.float_window_value("bh4", np.arange(nfft), nfft)
        )
        t = nfft + 5 * hop
        x = jnp.asarray(np.random.default_rng(5).normal(size=t))
        y = istft(stft(x, win, nfft, hop), win, hop)
        assert np.allclose(
            np.asarray(y)[nfft:-nfft], np.asarray(x)[nfft:-nfft], atol=1e-9
        )

    def test_separate_synthesis_window(self):
        """w_s = 1 (rect synthesis): normalization uses w_a * w_s, so
        reconstruction is still exact."""
        nfft, hop = 16, 8
        win = jnp.asarray(
            catalog.float_window_value("hamming", np.arange(nfft), nfft)
        )
        x = jnp.asarray(np.random.default_rng(6).normal(size=nfft + 7 * hop))
        s = stft(x, win, nfft, hop)
        y = istft(s, win, hop, synthesis_win=jnp.ones(nfft))
        assert np.allclose(np.asarray(y), np.asarray(x), atol=1e-9)

    def test_batched_channels(self):
        nfft, hop = 16, 8
        win = jnp.asarray(
            catalog.float_window_value("hann", np.arange(nfft), nfft)
        )
        x = jnp.asarray(np.random.default_rng(7).normal(size=(3, nfft + 5 * hop)))
        y = istft(stft(x, win, nfft, hop), win, hop)
        assert y.shape == x.shape
        assert np.allclose(
            np.asarray(y)[:, nfft:-nfft], np.asarray(x)[:, nfft:-nfft], atol=1e-9
        )

    def test_jit_clean(self):
        """Both directions compile (static shapes, no data-dependent
        control flow) and match eager."""
        spec = WindowSpec(phase_width=7, data_width=17)
        fwd, inv, _ = quantized_stft_pair("bh4", spec)
        x = jnp.asarray(
            np.random.default_rng(8).normal(size=spec.n * 4).astype(np.float32)
        )
        s_e, s_j = fwd(x), jax.jit(fwd)(x)
        assert np.allclose(np.asarray(s_e), np.asarray(s_j), atol=1e-6)
        y_e = inv(s_e)
        y_j = jax.jit(lambda s: inv(s))(s_j)
        assert np.allclose(np.asarray(y_e), np.asarray(y_j), atol=1e-6)

    def test_stft_matches_manual_frame(self):
        """Frame 0 of the STFT is literally rfft(x[:nfft] * win)."""
        nfft, hop = 16, 8
        win = jnp.asarray(
            catalog.float_window_value("bh3", np.arange(nfft), nfft)
        )
        x = jnp.asarray(np.random.default_rng(9).normal(size=nfft + 3 * hop))
        s = stft(x, win, nfft, hop)
        ref = jnp.fft.rfft(x[:nfft] * win)
        assert np.allclose(np.asarray(s[0]), np.asarray(ref), atol=1e-12)


class TestSharded:
    """make_sharded_stft on the virtual 8-device mesh: equality with the
    single-device STFT of the circularly-extended signal (SURVEY.md §4
    'sharded == single-device')."""

    @pytest.mark.parametrize("blocks,channels", [(4, 2), (8, 1), (2, 2)])
    def test_matches_single_device_circular(self, blocks, channels):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.stft import make_sharded_stft

        spec = WindowSpec(phase_width=6, data_width=17)
        nfft, hop = spec.n, spec.n // 2
        d = catalog.get("bh4")
        coeffs_q = d.quantized(spec.data_width)
        t = blocks * 4 * hop  # 4*hop samples per shard
        x = np.random.default_rng(10).normal(size=(channels, t)).astype(
            np.float32
        )

        mesh = make_mesh(blocks=blocks, channels=channels)
        fn = jax.jit(
            make_sharded_stft(mesh, spec, coeffs_q, d.shift, nfft, hop)
        )
        xs = jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks"))
        )
        got = np.asarray(fn(xs))

        # single-device reference: periodic framing == circular extension
        from blackman_harris_win.kernels.window import window_samples
        from blackman_harris_win.pipeline.spectral import window_scale

        wq = window_samples(jnp.arange(nfft, dtype=jnp.int32), coeffs_q, spec)
        win = wq.astype(jnp.float32) * jnp.float32(window_scale(spec, d.shift))
        xe = jnp.concatenate([jnp.asarray(x), jnp.asarray(x)[:, : nfft - hop]],
                             axis=-1)
        ref = np.asarray(stft(xe, win, nfft, hop))
        assert got.shape == ref.shape == (channels, t // hop, nfft // 2 + 1)
        assert np.allclose(got, ref, atol=1e-5)

    def test_frames_stay_block_sharded(self):
        """Frame m lives on the shard owning sample m*hop — the no-reshard
        contract for modify-then-istft stages."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.stft import make_sharded_stft

        spec = WindowSpec(phase_width=5, data_width=17)
        nfft, hop = spec.n, spec.n // 2
        d = catalog.get("hann")
        mesh = make_mesh(blocks=4, channels=2)
        fn = jax.jit(
            make_sharded_stft(
                mesh, spec, d.quantized(spec.data_width), d.shift, nfft, hop
            )
        )
        x = jax.device_put(
            jnp.zeros((2, 4 * 2 * hop), jnp.float32),
            NamedSharding(mesh, P("channels", "blocks")),
        )
        s = fn(x)
        # normalized spec may drop the trailing replicated axis
        assert tuple(s.sharding.spec)[:2] == ("channels", "blocks")

    def test_bad_hop_raises(self):
        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.stft import make_sharded_stft

        spec = WindowSpec(phase_width=5, data_width=17)
        d = catalog.get("hann")
        mesh = make_mesh(blocks=4, channels=1)
        fn = make_sharded_stft(
            mesh, spec, d.quantized(17), d.shift, spec.n, 12
        )  # 12 does not divide the 8-sample shard blocks
        with pytest.raises(ValueError, match="multiple of hop"):
            fn(jnp.zeros((1, 32), jnp.float32))

    @pytest.mark.parametrize("name", ["hann", "bh4", "bh7"])
    @pytest.mark.parametrize("div", [2, 4])
    def test_sharded_roundtrip_exact_everywhere(self, name, div):
        """sharded istft(sharded stft(x)) == x at ALL samples: circular
        framing gives every sample full overlap coverage, so the WOLA
        denominator is the closed-form periodic vector and there are no
        edge-conditioning caveats (unlike the finite-signal single-device
        path)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.stft import (
            make_sharded_istft,
            make_sharded_stft,
        )

        spec = WindowSpec(phase_width=6, data_width=17)
        nfft, hop = spec.n, spec.n // div
        d = catalog.get(name)
        q = d.quantized(spec.data_width)
        mesh = make_mesh(blocks=4, channels=2)
        fwd = jax.jit(make_sharded_stft(mesh, spec, q, d.shift, nfft, hop))
        inv = jax.jit(make_sharded_istft(mesh, spec, q, d.shift, nfft, hop))

        t = 4 * 4 * hop
        x = np.random.default_rng(11).normal(size=(2, t)).astype(np.float32)
        xs = jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks"))
        )
        y = np.asarray(inv(fwd(xs)))
        assert y.shape == x.shape
        assert np.allclose(y, x, atol=2e-5)

    def test_sharded_istft_requires_divisor_hop(self):
        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.stft import make_sharded_istft

        spec = WindowSpec(phase_width=5, data_width=17)
        d = catalog.get("hann")
        with pytest.raises(ValueError, match="hop"):
            make_sharded_istft(
                make_mesh(blocks=2), spec, d.quantized(17), d.shift,
                spec.n, 12,
            )
