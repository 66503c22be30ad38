"""Compensated-float32 window generation (kernels/compwin.py).

The round-4 capability: the reference's headline −180 dB BH-7 contract
(README.md:41,43-53) held in the *float* regime.  Feasibility bound (f32
format): rounding the exact f64 BH-7 window to f32 already floors at
−178.6 dB at pw=16 and −180.2 at pw=20, so the ≤ −180 dB pin at pw=16
belongs to the (hi, lo) pair output; the folded f32 output is pinned to
the format bound itself.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from blackman_harris_win.kernels.compwin import (
    DEFAULT_THRESH,
    comp_window,
    comp_window_block,
    comp_window_flops,
)
from blackman_harris_win.utils.spectral import window_sidelobe_db
from blackman_harris_win.windows.catalog import (
    float_window_value,
    get,
    names,
)


def _pair64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


class TestPairAccuracy:
    @pytest.mark.parametrize("name", names())
    def test_pair_matches_f64_golden(self, name):
        pw = 14
        hi, lo = comp_window(name, pw, pair=True)
        gold = float_window_value(name, np.arange(1 << pw), 1 << pw)
        # compensated error model ~2^-33-level; plain small harmonics up to
        # ~a_k * 2^-22.  Measured max across the catalog: 2.1e-9 (bh7).
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 5e-9

    def test_bh7_pair_error_pinned(self):
        pw = 16
        hi, lo = comp_window("bh7", pw, pair=True)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 1e-9  # measured 2.4e-10

    def test_pair_is_nonoverlapping(self):
        """TwoSum postcondition: hi == f32(hi + lo) (lo below hi's ulp)."""
        hi, lo = comp_window("bh7", 14, pair=True)
        hi64, lo64 = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
        refold = (hi64 + lo64).astype(np.float32)
        np.testing.assert_array_equal(refold, np.asarray(hi))

    def test_folded_is_format_accurate(self):
        """The folded f32 output is (to within the 3e-10 pair error) the
        correctly-rounded f32 of the exact window."""
        pw = 14
        w = np.asarray(comp_window("bh7", pw), np.float64)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        best32 = gold.astype(np.float32)
        best = best32.astype(np.float64)
        # every sample within one f32 ulp of the correctly-rounded value
        # (samples whose exact value sits near a rounding boundary may land
        # on the other side — the 3e-10 pair error allows that)
        assert np.max(np.abs(w - best)) <= np.max(np.spacing(best32))

    def test_all_plain_threshold_matches_floatwin(self):
        """thresh > max|a_k| compensates nothing: the e-path is then exactly
        floatwin's arithmetic (same tables, same order)."""
        from blackman_harris_win.kernels.floatwin import float_window

        pw = 12
        hi, lo = comp_window("bh4", pw, pair=True, thresh=1.1)
        plain = np.asarray(float_window("bh4", pw), np.float64)
        # not bit-equal (a0 split + TwoSum fold differ) but ~f32-close
        assert np.max(np.abs(_pair64(hi, lo) - plain)) < 3e-7


class TestSpectralFloors:
    def test_bh7_pair_holds_180_at_pw16(self):
        """THE round-4 pin: −180 dB for float consumers at pw=16 via the
        (hi, lo) pair (f64 floor −180.47; measured pair floor −180.41)."""
        hi, lo = comp_window("bh7", 16, pair=True)
        assert window_sidelobe_db(_pair64(hi, lo), n_terms=7) <= -180.0

    def test_bh7_folded_hits_format_bound_at_pw16(self):
        """Folded f32 floor equals the f32 *format* bound (the floor of the
        correctly-rounded f32 window) within 0.5 dB — no arithmetic noise
        above the format's own quantization."""
        n = 1 << 16
        gold = float_window_value("bh7", np.arange(n), n)
        bound = window_sidelobe_db(
            gold.astype(np.float32).astype(np.float64), n_terms=7
        )  # measured −178.64
        w = np.asarray(comp_window("bh7", 16), np.float64)
        fl = window_sidelobe_db(w, n_terms=7)
        assert fl <= bound + 0.5
        assert fl <= -178.0

    def test_bh7_folded_holds_180_at_pw20(self):
        """At pw=20 the format bound passes −180 (measured −180.2) and so
        must the folded output."""
        w = np.asarray(comp_window("bh7", 20), np.float64)
        assert window_sidelobe_db(w, n_terms=7) <= -180.0

    @pytest.mark.parametrize("name,bound", [
        ("hamming", -43.0),
        ("bh4", -92.0),
        ("bh5", -124.0),
    ])
    def test_published_floors_held_folded(self, name, bound):
        w = np.asarray(comp_window(name, 16), np.float64)
        assert window_sidelobe_db(w) <= bound


class TestBlocks:
    def test_blocks_tile_the_window(self):
        from blackman_harris_win.kernels.compwin import comp_window_pair

        pw, m, rows = 14, 8, 4
        hi_f, lo_f = comp_window_pair("bh7", pw, m=m)
        step = rows << m
        his, los = [], []
        for n0 in range(0, 1 << pw, step):
            h, l = comp_window_block(n0, rows, "bh7", pw, m=m)
            his.append(np.asarray(h))
            los.append(np.asarray(l))
        np.testing.assert_array_equal(np.concatenate(his), np.asarray(hi_f))
        np.testing.assert_array_equal(np.concatenate(los), np.asarray(lo_f))

    def test_traced_offset(self):
        """A traced n0 slices the right table rows.  NOT bitwise vs the
        eager path: under jit XLA may contract the e-path mul+add chains
        into FMAs (allowed — only *more* exact); the s-path stays exact
        either way, so the pair still meets the golden to pair accuracy."""
        pw, m = 13, 8

        @jax.jit
        def gen(n0):
            return comp_window_block(n0, 2, "bh4", pw, m=m)

        got_h, got_l = gen(jnp.int32(1 << m))
        n = (1 << m) + np.arange(2 << m)
        gold = float_window_value("bh4", n, 1 << pw)
        assert np.max(np.abs(_pair64(got_h, got_l) - gold)) < 5e-9

    def test_split_bounds(self):
        with pytest.raises(ValueError, match="split"):
            comp_window_block(0, 1, "hann", 10, m=10)

    def test_jit_fusion_regression(self):
        """Round-4 regression: under jit, XLA duplicated the (s, e)
        producer into the TwoSum's consumer fusions with different FMA
        contraction, breaking pair exactness at rounding-tie samples
        (1.5e-8 at 4/16384 — the exact shape below).  Fixed by returning
        the RAW pair from traced code and folding on the host
        (normalize_pair docstring has the full story)."""
        pw, m, rows, block = 14, 11, 2, 4096
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)

        @jax.jit
        def gen(n0):
            return comp_window_block(n0, rows, "bh7", pw, m=m)

        worst = 0.0
        for i in range(4):
            h, l = gen(jnp.int32(i * block))
            pair = _pair64(h, l)
            worst = max(worst, float(np.max(
                np.abs(pair - gold[i * block:(i + 1) * block]))))
        assert worst < 5e-9, worst

    def test_coeff_sum_guard(self):
        with pytest.raises(ValueError, match="1.9"):
            comp_window((0.9, 0.9, 0.9), 12)

    def test_tiny_pw_fallback(self):
        hi, lo = comp_window("bh7", 4, pair=True)
        gold = float_window_value("bh7", np.arange(16), 16)
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 1e-9
        folded = np.asarray(comp_window("bh7", 4))
        np.testing.assert_array_equal(folded, np.asarray(hi))


class TestOpModel:
    def test_flops_counts_comp_split(self):
        # bh7: a1..a4 >= 2^-7 compensated, a5/a6 plain
        per = 12 * 4 + 4 * 2 + 6
        assert comp_window_flops(10, "bh7") == 10 * per
        assert comp_window_flops(4, (0.5, 0.5)) == 4 * (12 + 6)


class TestPipelineIntegration:
    def test_welch_comp_mode_matches_float(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            windowed_power_spectrum,
        )

        spec = WindowSpec(8, 17)
        rng = np.random.default_rng(7)
        x = jnp.asarray(rng.normal(size=(2, 1024)).astype(np.float32))
        pf = np.asarray(
            windowed_power_spectrum(x, "bh4", spec, win_mode="float")
        )
        pc = np.asarray(
            windowed_power_spectrum(x, "bh4", spec, win_mode="comp")
        )
        assert pc.shape == pf.shape
        np.testing.assert_allclose(pc, pf, rtol=1e-4, atol=1e-7)
        with pytest.raises(ValueError, match="quantized integer"):
            windowed_power_spectrum(
                x, (40000, 30000), spec, win_mode="comp"
            )

    def test_sharded_welch_comp_mode(self):
        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.dist.mesh import make_mesh
        from blackman_harris_win.pipeline.spectral import (
            make_sharded_welch,
            windowed_power_spectrum,
        )

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        spec = WindowSpec(8, 17)
        nfft, hop = 256, 128
        rng = np.random.default_rng(8)
        x = jnp.asarray(rng.normal(size=(2, 4096)).astype(np.float32))
        fn = make_sharded_welch(mesh, spec, "bh7", 2, nfft, hop,
                                win_mode="comp")
        got = np.asarray(jax.jit(fn)(x))
        # sharded Welch is circular (right halo wraps); compare vs the
        # single-device circular equivalent
        xw = jnp.concatenate([x, x[:, :nfft - hop]], axis=1)
        want = np.asarray(
            windowed_power_spectrum(xw, "bh7", spec, hop=hop,
                                    win_mode="comp")
        )
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-8)

    def test_sharded_comp_window_pair(self):
        from blackman_harris_win.dist.generate import sharded_comp_window
        from blackman_harris_win.dist.mesh import make_mesh

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        pw = 14
        hi, lo = sharded_comp_window("bh7", pw, mesh)
        assert hi.shape == lo.shape == (1 << pw,)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 5e-9


class TestCompStftPair:
    def test_round_trip(self):
        from blackman_harris_win.pipeline.stft import comp_stft_pair

        fwd, inv, (whi, wlo) = comp_stft_pair("bh7", 7, hop=32)
        assert whi.dtype == jnp.float32 and whi.shape == (128,)
        rng = np.random.default_rng(13)
        x = jnp.asarray(rng.normal(size=(512,)).astype(np.float32))
        y = np.asarray(inv(fwd(x), length=512))
        np.testing.assert_allclose(
            y[128:-128], np.asarray(x)[128:-128], atol=1e-4
        )

    def test_matches_float_pair_spectra(self):
        from blackman_harris_win.pipeline.stft import (
            comp_stft_pair,
            float_stft_pair,
        )

        fwd_c, _, _ = comp_stft_pair("bh4", 7, hop=64)
        fwd_f, _, _ = float_stft_pair("bh4", 7, hop=64)
        rng = np.random.default_rng(14)
        x = jnp.asarray(rng.normal(size=(512,)).astype(np.float32))
        sc = np.asarray(fwd_c(x))
        sf = np.asarray(fwd_f(x))
        np.testing.assert_allclose(np.abs(sc), np.abs(sf),
                                   rtol=1e-4, atol=1e-5)


class TestDesignedWindows:
    def test_designed_7term_through_comp_path(self):
        """The −253 dB designed LP solution cannot survive any f32 output,
        but the pair must carry a designed K=5 set to its full floor."""
        from blackman_harris_win.windows.design import design_min_sidelobe

        r = design_min_sidelobe(5)
        hi, lo = comp_window(tuple(r.coeffs), 16, pair=True)
        fl = window_sidelobe_db(_pair64(hi, lo), n_terms=5)
        assert fl <= r.sidelobe_db + 1.0

    def test_designed_7term_pair_hits_sampled_floor(self):
        """The −253 dB K=7 design: the SAMPLED window's measurable floor is
        ~−180.8 (periodic sinc-tail aliasing at finite N, not the
        continuous-DTFT −253), and the comp pair carries it there exactly
        (pair error 2e-10 — below the aliasing floor)."""
        from blackman_harris_win.windows.design import design_min_sidelobe

        r = design_min_sidelobe(7)
        pw = 16
        hi, lo = comp_window(tuple(r.coeffs), pw, pair=True)
        pair = _pair64(hi, lo)
        n = np.arange(1 << pw)
        gold = np.full(n.shape, r.coeffs[0], np.float64)
        for k, a in enumerate(r.coeffs[1:], start=1):
            gold += ((-1.0) ** k) * a * np.cos(2 * np.pi * k * n / (1 << pw))
        assert np.max(np.abs(pair - gold)) < 1e-9
        fl_pair = window_sidelobe_db(pair, n_terms=7)
        fl_gold = window_sidelobe_db(gold, n_terms=7)
        assert fl_pair <= -180.5  # measured -180.8
        assert abs(fl_pair - fl_gold) < 0.2  # pair == f64 sampled floor


class TestPropertyGrid:
    @pytest.mark.parametrize("pw,m", [
        (10, 5), (12, 7), (12, 11), (14, 6), (14, 11), (13, 12),
    ])
    def test_pair_accuracy_across_splits(self, pw, m):
        from blackman_harris_win.kernels.compwin import comp_window_pair

        hi, lo = comp_window_pair("bh7", pw, m=m)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 5e-9, (pw, m)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_coefficient_sets(self, seed):
        """Random normalized K-term sets (the design-module output shape)
        hold pair accuracy — the grid-exactness argument is coefficient-
        independent as long as sum |a_k| < 1.9."""
        from blackman_harris_win.kernels.compwin import comp_window_pair

        rng = np.random.default_rng(seed)
        k = int(rng.integers(2, 8))
        a = rng.uniform(0.01, 1.0, k)
        a = a / a.sum()  # unit sum -> sum |a| == 1
        coeffs = tuple(float(v) for v in a)
        pw = 12
        hi, lo = comp_window_pair(coeffs, pw)
        n = np.arange(1 << pw)
        gold = np.full(n.shape, coeffs[0], np.float64)
        for j, aj in enumerate(coeffs[1:], start=1):
            gold += ((-1.0) ** j) * aj * np.cos(
                2.0 * np.pi * j * n / (1 << pw))
        assert np.max(np.abs(_pair64(hi, lo) - gold)) < 5e-9, coeffs
