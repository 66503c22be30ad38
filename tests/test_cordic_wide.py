"""Int32-lane datapaths for the wide CORDIC flavors + RTL windows.

Round-1 VERDICT item 1: the two-limb / radix-2^24 paths in
``kernels/pallas/cordic_wide.py`` and the RTL rounding contract in
``kernels/pallas/window_kernel.py`` must be full-period bit-exact vs the
native C++ oracle on pure int32 lanes, and the jnp flavor dispatch in
``kernels/cordic.py`` must route to them when int64 lanes are unavailable
(the production regime, exercised here by toggling x64 off).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from blackman_harris_win.core.config import CordicSpec, WindowSpec
from blackman_harris_win.kernels import cordic as kc
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.kernels.pallas import cordic_wide as cwide
from blackman_harris_win.kernels.pallas.window_kernel import (
    window_values,
    window_values_rtl,
)
from blackman_harris_win.model import golden, native
from blackman_harris_win.windows import catalog


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.build()


def _full(pw):
    return np.arange(1 << pw, dtype=np.int64)


def _i32(n):
    return jnp.asarray(n, jnp.int32)


class TestPrerotatedFlavorsFullPeriod:
    """dds48 / scaled on int32 lanes == native oracle, every phase."""

    @pytest.mark.parametrize("pw,w", [(14, 32), (12, 24), (10, 16)])
    def test_dds48(self, pw, w):
        n = _full(pw)
        c, s = cwide.cordic_dds48_i32(_i32(n), pw, w)
        nc, ns = native.cordic_dds48(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("pw,w", [(14, 32), (12, 20), (12, 16)])
    def test_scaled(self, pw, w):
        # w=32 -> SIZE 48 (two-limb), w=20 -> SIZE 38, w=16 -> SIZE 30 (i32)
        n = _full(pw)
        c, s = cwide.cordic_scaled_i32(_i32(n), pw, w)
        nc, ns = native.cordic_scaled(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)


class TestOutputFixFlavorsFullPeriod:
    """dds / hls wide datapaths on int32 lanes == native oracle."""

    @pytest.mark.parametrize(
        "pw,w,p",
        [
            (14, 32, 1),  # iw=33: radix-2 fast path
            (14, 32, 2),  # iw=34: radix-4 fast path (i<s shift branch)
            (12, 31, 2),  # iw=33 at w=31
            (11, 32, 7),  # iw=39: generic radix-2^24 limb path
        ],
    )
    def test_dds(self, pw, w, p):
        n = _full(pw)
        c, s = cwide.cordic_dds_i32(_i32(n), pw, w, p)
        nc, ns = native.cordic_dds(n, pw, w, p)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("pw,w", [(14, 32), (12, 31)])
    def test_hls(self, pw, w):
        n = _full(pw)
        c, s = cwide.cordic_hls_i32(_i32(n), pw, w)
        nc, ns = native.cordic_hls(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("pw,w,p", [(12, 24, 1), (10, 32, 1), (12, 16, 3)])
    def test_cmodel_spot(self, pw, w, p):
        # No native cmodel oracle; spot-sweep vs the Python golden model.
        ph = np.unique(
            np.concatenate(
                [np.arange(0, 1 << pw, max(1, (1 << pw) // 512)),
                 np.array([0, 1, (1 << (pw - 2)) - 1, 1 << (pw - 2),
                           (1 << (pw - 1)), (3 << (pw - 2)), (1 << pw) - 1])]
            )
        )
        c, s = cwide.cordic_cmodel_i32(_i32(ph), pw, w, p)
        for i, n in enumerate(ph):
            gc, gs = golden.cordic_cmodel(int(n), pw, w, p)
            assert (int(c[i]), int(s[i])) == (gc, gs), (pw, w, p, n)


class TestAtan2WideLanes:
    def test_atan2_aw32_dense(self):
        rng = np.random.default_rng(7)
        x = rng.integers(-(1 << 15), 1 << 15, size=20000)
        y = rng.integers(-(1 << 15), 1 << 15, size=20000)
        q, dat_phi = cwide.cordic_atan2_core_i32(_i32(y), _i32(x), 16, 32, 1)
        # Reconstruct the faithful quadrant fix (src/cordic_atan2.vhd:204-219)
        phi_pi = 1 << 30
        out = np.where(
            np.asarray(q) == 0,
            dat_phi,
            np.where(
                np.asarray(q) == 1,
                dat_phi + phi_pi,
                np.where(np.asarray(q) == 2, -np.asarray(dat_phi), dat_phi - phi_pi),
            ),
        ).astype(np.int64)
        out = (out << 32) >> 32  # wrap to 32 bits
        na = native.cordic_atan2(y, x, 16, 32)
        np.testing.assert_array_equal(out, na)


class TestWindowRtlInt32FullPeriod:
    """The VHDL rounding contract on int32 lanes == native win_rtl oracle."""

    @pytest.mark.parametrize(
        "name,pw,w,p",
        [
            ("bh7", 13, 32, 1),       # the -180 dB regime, radix-4 tree
            ("hamming", 13, 32, 1),   # 2-term radix-2 subtract path
            ("bh4", 12, 31, 1),       # w=31 lane regime
            ("bh3", 12, 20, 2),       # narrow int32 regime + guard bits
            ("flattop1", 12, 32, 1),  # negative coefficients
            ("bh5", 11, 17, 1),       # all-int32 narrow
        ],
    )
    def test_full_period(self, name, pw, w, p):
        n = _full(pw)
        spec = WindowSpec(pw, w, rounding="rtl", overflow="wrap", precision=p)
        q = catalog.get(name).quantized(w)
        got = np.asarray(
            window_values_rtl(_i32(n), q, spec), np.int64
        )
        want = native.win_rtl(n, q, pw, w, p)
        np.testing.assert_array_equal(got, want)

    def test_rtl_matches_jnp_reference(self):
        # Same datapath through the int64 jnp reference (_window_rtl).
        spec = WindowSpec(12, 32, rounding="rtl", overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        n = np.arange(0, 1 << 12, 7)
        got = np.asarray(window_values(_i32(n), q, spec), np.int64)
        want = np.asarray(kw.window_samples(n, q, spec), np.int64)
        np.testing.assert_array_equal(got, want)


class TestDispatchWithoutX64:
    """kernels/cordic.py + kernels/window.py route to the int32-lane paths
    when int64 lanes are unavailable (x64 off)."""

    @pytest.fixture(autouse=True)
    def _no_x64(self):
        jax.config.update("jax_enable_x64", False)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", True)

    @pytest.mark.parametrize(
        "flavor,pw,w,p",
        [
            ("dds48", 12, 24, 1),
            ("scaled", 12, 20, 1),
            ("dds", 12, 32, 1),
            ("hls", 12, 32, 1),
            ("cmodel", 12, 16, 1),
        ],
    )
    def test_cordic_flavors(self, flavor, pw, w, p):
        ph = np.arange(0, 1 << pw, 13, dtype=np.int32)
        spec = CordicSpec(pw, w, flavor, p)
        c, s = kc.cordic_sincos(jnp.asarray(ph), spec)
        gfn = {
            "dds48": lambda n: golden.cordic_dds48(n, pw, w),
            "scaled": lambda n: golden.cordic_scaled(n, pw, w),
            "dds": lambda n: golden.cordic_dds(n, pw, w, p),
            "hls": lambda n: golden.cordic_hls(n, pw, w),
            "cmodel": lambda n: golden.cordic_cmodel(n, pw, w, p),
        }[flavor]
        for i, n in enumerate(ph[::17]):
            gc, gs = gfn(int(n))
            j = int(np.where(ph == n)[0][0])
            assert (int(c[j]), int(s[j])) == (gc, gs), (flavor, n)

    def test_window_rtl_dispatch(self):
        spec = WindowSpec(12, 32, rounding="rtl", overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        n = np.arange(0, 1 << 12, 11, dtype=np.int32)
        got = np.asarray(kw.window_samples(jnp.asarray(n), q, spec))
        for i, ni in enumerate(n[::23]):
            want = golden.win_cosine_sum_rtl(int(ni), tuple(int(c) for c in q), 12, 32)
            j = int(np.where(n == ni)[0][0])
            assert int(got[j]) == want, ni

    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    @pytest.mark.parametrize(
        "name,w",
        [("hann", 17), ("bh3_hls", 24), ("hann", 31), ("hann", 32),
         ("bh3_hls", 32)],
    )
    def test_taylor_window_dispatch(self, rounding, name, w):
        # TAYLOR-source windows previously needed int64 product lanes even
        # at w=17; now exact on int32 at every width (mul_shift30 up to
        # w=30/31, mul_wide_parts31 for the full-scale w=32 products).
        pw, ls = 12, 9
        spec = WindowSpec(pw, w, sin_type="taylor", rounding=rounding,
                          lut_size=ls, overflow="wrap")
        q = catalog.get(name).quantized(w)
        n = np.arange(0, 1 << pw, 17, dtype=np.int32)
        got = np.asarray(kw.window_samples(jnp.asarray(n), q, spec))

        def gold(nn):
            coeffs = tuple(int(c) for c in q)
            acc = coeffs[0]
            bs = []
            for k in range(1, len(coeffs)):
                pwk = pw - (k - 1)
                gc, _ = golden.taylor_sincos(nn & ((1 << pwk) - 1), pwk, w, ls)
                if rounding == "hls":
                    bs.append((coeffs[k] * gc) >> (w - 1))
                else:
                    p = coeffs[k] * gc
                    from blackman_harris_win.core.fixedpoint import wrap
                    r = wrap(p >> (w - 2), w + 1)
                    bs.append(wrap((r >> 1) + (r & 1), w))
            from blackman_harris_win.core.fixedpoint import wrap
            if rounding == "hls":
                for k, m in enumerate(bs, start=1):
                    acc = acc - m if k % 2 == 1 else acc + m
                return wrap(acc, w)
            if len(coeffs) == 2:
                pp = wrap(coeffs[0] - bs[0], w + 1)
                return wrap((pp >> 1) + (pp & 1), w)
            for k, b in enumerate(bs, start=1):
                acc = acc - b if k % 2 == 1 else acc + b
            pp = wrap(acc, w + 2)
            return wrap((pp >> 2) + ((pp >> 1) & 1), w)

        for j in range(0, len(n), 13):
            assert int(got[j]) == gold(int(n[j])), (rounding, name, int(n[j]))

    def test_atan2_dispatch(self):
        rng = np.random.default_rng(3)
        x = rng.integers(-(1 << 15), 1 << 15, size=512).astype(np.int32)
        y = rng.integers(-(1 << 15), 1 << 15, size=512).astype(np.int32)
        ja = np.asarray(kc.cordic_atan2(y, x, 16, 32), np.int64)
        for i in range(0, 512, 37):
            assert int(ja[i]) == golden.cordic_atan2(int(y[i]), int(x[i]), 16, 32)


class TestInt32EnginesWidthGrid:
    """Every output width 8..32 for every int32-lane engine vs the native
    oracle (random + quadrant-seam phases) — catches width-specific lane
    bugs (limb boundaries, SEL_SIZE steps, radix-2^s applicability)."""

    def _phases(self, pw, rng):
        seams = np.array([0, 1, (1 << (pw - 2)) - 1, 1 << (pw - 2),
                          (1 << (pw - 1)) - 1, 1 << (pw - 1),
                          (3 << (pw - 2)), (1 << pw) - 1])
        r = rng.integers(0, 1 << pw, size=248)
        return np.unique(np.concatenate([seams, r]))

    @pytest.mark.parametrize("w", list(range(8, 33, 2)))
    def test_all_engines(self, w):
        rng = np.random.default_rng(w)
        pw = int(rng.integers(8, 27))
        ph = self._phases(pw, rng)
        p = int(rng.integers(1, 8))

        c, s = cwide.cordic_dds48_i32(_i32(ph), pw, w)
        nc, ns = native.cordic_dds48(ph, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc, err_msg=f"dds48 w={w}")
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

        c, s = cwide.cordic_scaled_i32(_i32(ph), pw, w)
        nc, ns = native.cordic_scaled(ph, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc, err_msg=f"scaled w={w}")
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

        c, s = cwide.cordic_dds_i32(_i32(ph), pw, w, p)
        nc, ns = native.cordic_dds(ph, pw, w, p)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc, err_msg=f"dds w={w} p={p}")
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

        c, s = cwide.cordic_hls_i32(_i32(ph), pw, w)
        nc, ns = native.cordic_hls(ph, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc, err_msg=f"hls w={w}")
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("w", list(range(9, 33, 4)))
    def test_rtl_window_widths(self, w):
        rng = np.random.default_rng(1000 + w)
        pw = int(rng.integers(8, 20))
        name = ["bh3", "bh4", "bh5", "bh7", "hamming", "hann"][w % 6]
        q = catalog.get(name).quantized(w)
        spec = WindowSpec(pw, w, rounding="rtl", overflow="wrap")
        n = self._phases(pw, rng)
        got = np.asarray(window_values_rtl(_i32(n), q, spec), np.int64)
        want = native.win_rtl(n, q, pw, w, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} w={w}")


class TestPw30Routing:
    """pw=30 (1G-point window) routes to the int32 paths without x64 —
    the (k*n) int32 overflow is exact under the 2^pw mask."""

    @pytest.fixture(autouse=True)
    def _no_x64(self):
        jax.config.update("jax_enable_x64", False)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", True)

    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    def test_pw30_w32_window(self, rounding):
        pw, w = 30, 32
        spec = WindowSpec(pw, w, rounding=rounding, overflow="wrap")
        q = catalog.get("bh7").quantized(w)
        n = np.array([0, 1, (1 << 28) - 1, 1 << 28, (1 << 29) + 12345,
                      (3 << 28) + 7, (1 << 30) - 1], dtype=np.int32)
        got = np.asarray(kw.window_samples(jnp.asarray(n), q, spec))
        coeffs = tuple(int(c) for c in q)
        for j, nj in enumerate(n):
            if rounding == "hls":
                want = golden.win_cosine_sum_hls(int(nj), coeffs, pw, w)
            else:
                want = golden.win_cosine_sum_rtl(int(nj), coeffs, pw, w)
            assert int(got[j]) == want, (rounding, int(nj))
