"""Taylor fast path: bit-exact vs golden model, float accuracy, windows.

Mirrors the reference's tb_windows methodology (src/tb/tb_windows.vhd:305-350):
the interpolating generator (LUT_SIZE < PHASE_WIDTH-2) is compared against an
exact-LUT instance (LUT_SIZE = PHASE_WIDTH-2, no interpolation error) of the
same entity, plus float-reference bounds.
"""

import math

import numpy as np
import pytest

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels import taylor as kt
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.model import golden
from blackman_harris_win.windows import catalog


class TestBitExactVsGolden:
    @pytest.mark.parametrize(
        "pw,w,ls",
        [
            (10, 16, 8),   # interpolating (pw-ls > 2)
            (11, 16, 9),   # interpolating, tb_windows config
            (10, 16, 9),   # pw-ls == 2? no: 1 -> top-aligned pure LUT
            (12, 10, 10),  # pw-ls == 2: exact LUT
            (14, 24, 10),  # W >= 19 datapath (product-slice + clamp)
            (12, 32, 9),   # widest output
        ],
    )
    def test_matches_scalar_model(self, pw, w, ls):
        n = np.arange(0, 1 << pw, max(1, (1 << pw) // 1024))
        n = np.unique(np.concatenate([n, [(1 << pw) - 1, (1 << (pw - 1))]]))
        c, s = kt.taylor_sincos(n, pw, w, ls)
        for i, p in enumerate(n):
            gc, gs = golden.taylor_sincos(int(p), pw, w, ls)
            assert int(c[i]) == gc, (pw, w, ls, int(p))
            assert int(s[i]) == gs, (pw, w, ls, int(p))

    def test_lut_size_validation(self):
        with pytest.raises(ValueError):
            kt.taylor_sincos(np.arange(4), 10, 16, 10)


class TestAccuracy:
    def test_exact_lut_is_exact(self):
        # LUT_SIZE = PW-2: every sample is a ROM entry -> error <= 1 LSB
        pw, w = 12, 16
        n = np.arange(1 << pw)
        c, s = kt.taylor_sincos(n, pw, w, pw - 2)
        th = 2 * math.pi * n / (1 << pw)
        amp = 2.0 ** (w - 1) - 1.0
        assert np.abs(np.asarray(c) - np.round(amp * np.cos(th))).max() <= 1
        assert np.abs(np.asarray(s) - np.round(amp * np.sin(th))).max() <= 1

    def test_interpolation_vs_exact_reference(self):
        # tb_windows style: approx (LUT_SIZE=10) vs exact (LUT_SIZE=PW-2)
        pw, w = 14, 16
        n = np.arange(0, 1 << pw, 5)
        ca, _ = kt.taylor_sincos(n, pw, w, 10)
        ce, _ = kt.taylor_sincos(n, pw, w, pw - 2)
        diff = np.abs(np.asarray(ca, np.int64) - np.asarray(ce, np.int64))
        # 1st-order Taylor residual at LUT_SIZE=10: delta^2/2 ~ 2^-22 of
        # full scale -> well under a few LSB at W=16
        assert diff.max() <= 4, diff.max()

    @pytest.mark.parametrize("w,ls,bound_lsb", [(16, 10, 3), (24, 12, 16)])
    def test_float_error_bound(self, w, ls, bound_lsb):
        pw = 14
        n = np.arange(0, 1 << pw, 7)
        c, s = kt.taylor_sincos(n, pw, w, ls)
        th = 2 * math.pi * n / (1 << pw)
        amp = 2.0 ** (w - 1) - 1.0
        err = np.abs(np.asarray(c, np.float64) - amp * np.cos(th))
        assert err.mean() < bound_lsb, err.mean()


class TestTaylorWindows:
    @pytest.mark.parametrize("name", ["hamming", "hann", "bh3_hls", "blackman"])
    def test_window_float_rms(self, name):
        # TAYLOR sin-source windows (2/3-term only), full-scale amplitude:
        # same RMS acceptance as the reference's window test
        pw, w = 12, 16
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=10,
                          overflow="saturate")
        N = 1 << pw
        out = np.asarray(kw.make_window(name, spec), np.float64)
        gold = catalog.golden_quantized_window(name, np.arange(N), N, w)
        rms = np.sqrt(np.sum((out - gold) ** 2)) / N
        assert rms < 10, (name, rms)

    def test_taylor_rejects_4term(self):
        spec = WindowSpec(12, 16, sin_type="taylor")
        with pytest.raises(ValueError):
            kw.make_window("bh4", spec)

    def test_rtl_taylor_scaling_is_full_scale(self):
        # With TAYLOR (amplitude 2^(W-1)) the RTL datapath is properly
        # scaled: peak of hamming ~ (a0+a1) * 2^(W-1) / 2 after final round.
        pw, w = 12, 16
        spec = WindowSpec(pw, w, sin_type="taylor", rounding="rtl",
                          lut_size=10, overflow="saturate")
        out = np.asarray(kw.make_window("hamming", spec), np.float64)
        peak = out.max()
        # final round in 2-term RTL divides by 2: peak ~ 2^(W-1)/2
        assert abs(peak - 2.0 ** (w - 2)) < 2 ** (w - 6), peak


class TestCounterEquivalence:
    def test_counter_equivalence_periodicity(self):
        """PARITY.md quirk pin: the reference taylor_sincos free-runs an
        internal counter (src/taylor_sincos.vhd:144-153 — no phase input);
        the repo's index argument is that counter's state, so outputs must
        be periodic mod 2^PW exactly as the wrapping counter is, and a
        sequential index sweep IS the reference's output stream."""
        pw, w, ls = 10, 16, 8
        n = np.arange(1 << pw)
        c0, s0 = kt.taylor_sincos(n, pw, w, ls)
        # counter wrap: samples [2^PW, 2*2^PW) repeat the first period
        c1, s1 = kt.taylor_sincos(n + (1 << pw), pw, w, ls)
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
        # and an arbitrary later window of the stream equals the counter
        # state slice (stream position 3*2^PW + 100 == counter 100)
        off = 3 * (1 << pw) + 100
        c2, s2 = kt.taylor_sincos(np.arange(off, off + 64), pw, w, ls)
        np.testing.assert_array_equal(np.asarray(c2), np.asarray(c0)[100:164])
        np.testing.assert_array_equal(np.asarray(s2), np.asarray(s0)[100:164])


class TestWideTaylorInt32Lanes:
    """data_width 31/32 Taylor correction on pure int32 lanes
    (limb.mul_small_shift) — previously int64-only (raised with x64 off)."""

    @pytest.mark.parametrize("pw,w,ls", [(14, 31, 9), (14, 32, 10), (12, 32, 8)])
    def test_full_period_vs_native(self, pw, w, ls):
        from blackman_harris_win.model import native

        native.build()
        n = np.arange(1 << pw)
        jc, js = kt.taylor_sincos(n, pw, w, ls)
        nc, ns = native.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(np.asarray(jc, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(js, np.int64), ns)

    def test_runs_without_x64(self):
        import jax

        jax.config.update("jax_enable_x64", False)
        try:
            c, s = kt.taylor_sincos(np.arange(0, 1 << 12, 7, dtype=np.int32),
                                    12, 32, 8)
            for j in (0, 11, 222, 333):
                n = 7 * j
                gc, gs = golden.taylor_sincos(n, 12, 32, 8)
                assert (int(c[j]), int(s[j])) == (gc, gs), n
        finally:
            jax.config.update("jax_enable_x64", True)

    def test_rejects_width_over_32(self):
        # the int32 datapath would silently truncate; must fail loudly
        with pytest.raises(ValueError, match="data_width <= 32"):
            kt.taylor_sincos(np.arange(8), 12, 34, 8)


class TestBlockKernel:
    """Gather-free taylor_sincos_block / taylor_window_block (round 4):
    bit-exact vs the indexed form across all three PW-LS regimes, quadrant
    wraps, period wraps, and both tay1 width branches."""

    @pytest.mark.parametrize("pw,w,ls", [
        (14, 16, 10),   # tay1, W<19 branch
        (14, 24, 10),   # tay1, W>=19 branch (saturating)
        (12, 16, 10),   # pw-ls == 2: exact LUT
        (11, 16, 10),   # pw-ls < 2: over-wide LUT (strided)
        (14, 32, 12),   # w=32 lanes
    ])
    def test_bit_exact_vs_indexed(self, pw, w, ls):
        rsh = max(pw - ls - 2, 0)
        r = 1 << rsh
        count = min(64, 1 << ls) * r
        # blocks spanning: start, the N/4 quadrant seam, and the period wrap
        starts = [0, (1 << (pw - 2)) - (count // 2) // r * r,
                  (1 << pw) - count]
        for n0 in starts:
            n0 = (n0 // r) * r
            cb, sb = kt.taylor_sincos_block(n0, count, pw, w, ls)
            n = np.arange(n0, n0 + count)
            ci, si = kt.taylor_sincos(n, pw, w, ls)
            np.testing.assert_array_equal(np.asarray(cb), np.asarray(ci),
                                          err_msg=f"cos n0={n0}")
            np.testing.assert_array_equal(np.asarray(sb), np.asarray(si),
                                          err_msg=f"sin n0={n0}")

    def test_traced_offset(self):
        import jax
        import jax.numpy as jnp

        pw, w, ls = 14, 16, 10
        r = 1 << (pw - ls - 2)

        @jax.jit
        def gen(n0):
            return kt.taylor_sincos_block(n0, 8 * r, pw, w, ls)

        c, s = gen(jnp.int32(32 * r))
        ci, si = kt.taylor_sincos(np.arange(32 * r, 40 * r), pw, w, ls)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(ci))
        np.testing.assert_array_equal(np.asarray(s), np.asarray(si))

    def test_alignment_and_size_guards(self):
        pw, w, ls = 14, 16, 10
        r = 1 << (pw - ls - 2)
        with pytest.raises(ValueError, match="multiple of R"):
            kt.taylor_sincos_block(0, r + 1, pw, w, ls)
        with pytest.raises(ValueError, match="R-aligned"):
            kt.taylor_sincos_block(1, r, pw, w, ls)
        with pytest.raises(ValueError, match="split the block"):
            kt.taylor_sincos_block(0, (1 << ls) * r + r, pw, w, ls)

    @pytest.mark.parametrize("name,w", [
        ("hamming", 16), ("blackman", 24), ("bh3_hls", 32),
    ])
    def test_window_block_bit_exact(self, name, w):
        from blackman_harris_win.kernels.taylor import taylor_window_block

        pw, ls = 14, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                          rounding="hls", overflow="wrap")
        q = catalog.get(name).quantized(w)
        r1 = 1 << (pw - ls - 2)
        count = 32 * r1
        for n0 in (0, (1 << (pw - 2)) - count // 2, (1 << pw) - count):
            n0 = (n0 // r1) * r1
            got = np.asarray(taylor_window_block(n0, count, q, spec))
            n = np.arange(n0, n0 + count)
            want = np.asarray(kw.window_samples(n, q, spec))
            np.testing.assert_array_equal(got, want, err_msg=f"n0={n0}")

    def test_make_window_routes_through_block_kernel(self):
        """make_window's TAYLOR fast-path chunks == the indexed form for
        2- and 3-term windows (incl. the k=2 row-bound sizing)."""
        for name, w, pw, ls in (("hamming", 16, 12, 10), ("blackman", 24, 14, 10),
                                ("hann", 16, 11, 10),
                                # k=1 exact-LUT / k=2 over-wide mix
                                ("blackman", 16, 12, 10),
                                # k=1 tay1 / k=2 exact-LUT mix
                                ("bh3_hls", 16, 13, 10)):
            spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                              rounding="hls", overflow="wrap")
            got = np.asarray(kw.make_window(name, spec))
            q = catalog.get(name).quantized(w)
            want = np.asarray(kw.window_samples(np.arange(1 << pw), q, spec))
            np.testing.assert_array_equal(got, want, err_msg=name)

    def test_range_helper_chunks(self):
        from blackman_harris_win.kernels.taylor import taylor_window_range

        pw, w, ls = 13, 16, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                          rounding="hls", overflow="wrap")
        q = catalog.get("blackman").quantized(w)
        # a range wider than one chunk bound (2^(pw-3))
        count = 1 << (pw - 1)
        got = np.asarray(taylor_window_range(1 << (pw - 2), count, q, spec))
        n = (1 << (pw - 2)) + np.arange(count)
        want = np.asarray(kw.window_samples(n, q, spec))
        np.testing.assert_array_equal(got, want)

    def test_sharded_taylor_window_bitwise(self):
        """dist.generate routes TAYLOR/HLS shards through the block kernel;
        sharded == single-device bitwise must still hold."""
        import jax

        from blackman_harris_win.dist.generate import sharded_window
        from blackman_harris_win.dist.mesh import make_mesh

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        pw, w, ls = 13, 16, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                          rounding="hls", overflow="wrap")
        q = catalog.get("hamming").quantized(w)
        got = np.asarray(sharded_window(q, spec, mesh))
        want = np.asarray(kw.window_samples(np.arange(1 << pw), q, spec))
        np.testing.assert_array_equal(got, want)

    def test_window_block_routes_and_matches(self):
        pw, w, ls = 13, 16, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                          rounding="hls", overflow="wrap")
        q = catalog.get("blackman").quantized(w)
        r1 = 1 << (pw - ls - 2)
        got = np.asarray(kw.window_block(4 * r1, 16 * r1, q, spec))
        want = np.asarray(kw.window_samples(
            4 * r1 + np.arange(16 * r1), q, spec))
        np.testing.assert_array_equal(got, want)
        # unaligned n0 falls back to the indexed form (still correct)
        got2 = np.asarray(kw.window_block(4 * r1 + 1, 16 * r1, q, spec))
        want2 = np.asarray(kw.window_samples(
            4 * r1 + 1 + np.arange(16 * r1), q, spec))
        np.testing.assert_array_equal(got2, want2)


class TestAdvisorRound4Fixes:
    """Round-5 regression pins for the round-4 advisor findings."""

    def test_traced_unaligned_n0_window_block_correct(self):
        """A traced (non-int) n0 cannot be alignment-checked, so
        window_block must take the indexed path — previously it routed
        through the block kernel unconditionally and an unaligned traced
        offset returned wrong samples."""
        import jax
        import jax.numpy as jnp

        pw, w, ls = 13, 16, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls,
                          rounding="hls", overflow="wrap")
        q = catalog.get("blackman").quantized(w)
        r1 = 1 << (pw - ls - 2)
        count = 16 * r1

        @jax.jit
        def gen(n0):
            return kw.window_block(n0, count, q, spec)

        for off in (0, 1, r1 - 1):  # aligned and unaligned traced offsets
            n0 = 4 * r1 + off
            got = np.asarray(gen(jnp.int32(n0)))
            want = np.asarray(kw.window_samples(
                n0 + np.arange(count), q, spec))
            np.testing.assert_array_equal(got, want, err_msg=f"n0={n0}")

    def _exact_taylor_window(self, n, q, pw, ls, clip):
        """Exact scalar model of the 3-term taylor-source HLS window at
        w=32 (python ints; clip=True applies int32 saturation)."""
        acc = q[0]
        for k in range(1, len(q)):
            pwk = pw - (k - 1)
            c, _ = golden.taylor_sincos(n & ((1 << pwk) - 1), pwk, 32, ls)
            m = (q[k] * c) >> 31
            acc = acc - m if k % 2 == 1 else acc + m
        if clip:
            return max(-(1 << 31), min((1 << 31) - 1, acc))
        return ((acc + (1 << 31)) % (1 << 32)) - (1 << 31)

    def test_w32_saturate_tracking_block_kernel(self):
        """taylor_window_block at w=32 with overflow='saturate' must clamp
        via overflow tracking (the int32 accumulator IS the W-bit register;
        a plain clip after the wrap is a no-op)."""
        pw, ls = 12, 9
        # deliberately overflowing set: peak ~ q0+q1+q2 > 2^31-1
        q = (900_000_000, 900_000_000, 500_000_000)
        r1 = 1 << (pw - ls - 2)
        n0, count = (1 << (pw - 1)) - 32 * r1, 64 * r1  # spans the peak
        sat = WindowSpec(pw, 32, sin_type="taylor", lut_size=ls,
                         rounding="hls", overflow="saturate")
        wrp = WindowSpec(pw, 32, sin_type="taylor", lut_size=ls,
                         rounding="hls", overflow="wrap")
        got_s = np.asarray(kt.taylor_window_block(n0, count, q, sat))
        got_w = np.asarray(kt.taylor_window_block(n0, count, q, wrp))
        overflowed = False
        for i in range(count):
            n = n0 + i
            es = self._exact_taylor_window(n, q, pw, ls, clip=True)
            ew = self._exact_taylor_window(n, q, pw, ls, clip=False)
            assert int(got_s[i]) == es, n
            assert int(got_w[i]) == ew, n
            overflowed = overflowed or es != ew
        assert overflowed  # the sweep actually exercised saturation

    def test_w32_saturate_tracking_window_samples(self):
        """window_samples' _window_hls on int32 lanes honors w=32 saturate
        via the same overflow tracking."""
        pw, ls = 12, 9
        q = (900_000_000, 900_000_000, 500_000_000)
        n = (1 << (pw - 1)) + np.arange(-8, 8)
        sat = WindowSpec(pw, 32, sin_type="taylor", lut_size=ls,
                         rounding="hls", overflow="saturate")
        got = np.asarray(kw.window_samples(n, q, sat))
        for i, ni in enumerate(n):
            assert int(got[i]) == self._exact_taylor_window(
                int(ni), q, pw, ls, clip=True), ni
