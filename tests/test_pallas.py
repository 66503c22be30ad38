"""int32-lane window datapaths (``kernels/pallas/``) bit-exact vs the jnp
reference and the golden model: the limb arithmetic, the single-limb,
two-limb and radix-4 CORDIC cosines, and ``window_values``, which serves
every wide configuration while x64 is off.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.kernels.pallas import limb
from blackman_harris_win.kernels.pallas.window_kernel import (
    _cos_i32,
    _cos_wide,
    window_values,
)
from blackman_harris_win.model import golden
from blackman_harris_win.windows import catalog


class TestLimb:
    def test_roundtrip_and_ops(self):
        rng = np.random.default_rng(0)
        iw = 40
        vals = rng.integers(-(1 << 39), 1 << 39, size=256)
        a = [limb.const(int(v), iw) for v in vals]
        # const/value roundtrip
        for v, (hi, lo) in zip(vals, a):
            assert hi * (1 << limb.L) + lo == int(v)

    @pytest.mark.parametrize("k", [0, 1, 5, 23, 24, 25, 39, 47])
    def test_shr_matches_python(self, k):
        rng = np.random.default_rng(k)
        iw = 48
        vals = [int(v) for v in rng.integers(-(1 << 47), 1 << 47, size=128)]
        hi = jnp.asarray([limb.const(v, iw)[0] for v in vals], jnp.int32)
        lo = jnp.asarray([limb.const(v, iw)[1] for v in vals], jnp.int32)
        rh, rl = limb.shr((hi, lo), k)
        for i, v in enumerate(vals):
            want = v >> k
            got = int(rh[i]) * (1 << limb.L) + int(rl[i])
            assert got == want, (k, v)

    def test_add_sub_wrap(self):
        rng = np.random.default_rng(3)
        iw = 34
        from blackman_harris_win.core.fixedpoint import wrap as pywrap

        va = [int(v) for v in rng.integers(-(1 << 33), 1 << 33, size=128)]
        vb = [int(v) for v in rng.integers(-(1 << 33), 1 << 33, size=128)]
        A = tuple(
            jnp.asarray([limb.const(v, iw)[j] for v in va], jnp.int32)
            for j in (0, 1)
        )
        B = tuple(
            jnp.asarray([limb.const(v, iw)[j] for v in vb], jnp.int32)
            for j in (0, 1)
        )
        S = limb.wrap(limb.add(A, B), iw)
        D = limb.wrap(limb.sub(A, B), iw)
        for i in range(128):
            assert int(S[0][i]) * (1 << limb.L) + int(S[1][i]) == pywrap(
                va[i] + vb[i], iw
            )
            assert int(D[0][i]) * (1 << limb.L) + int(D[1][i]) == pywrap(
                va[i] - vb[i], iw
            )

    @pytest.mark.parametrize("shift", [20, 23, 25, 28, 35])
    def test_mul_small_shift_exact(self, shift):
        rng = np.random.default_rng(100 + shift)
        a = rng.integers(0, 1 << 20, size=512)
        c = rng.integers(-(1 << 31) + 1, 1 << 31, size=512)
        got = limb.mul_small_shift(
            jnp.asarray(a, jnp.int32), jnp.asarray(c, jnp.int32), shift
        )
        for i in range(512):
            want = (int(a[i]) * int(c[i])) >> shift
            assert int(got[i]) == want, (shift, int(a[i]), int(c[i]))

    def test_mul_small_shift_rejects_small_shift(self):
        with pytest.raises(ValueError):
            limb.mul_small_shift(jnp.int32(1), jnp.int32(1), 19)

    @pytest.mark.parametrize("shift", [22, 28, 30, 32])
    def test_mul_shift30_exact(self, shift):
        rng = np.random.default_rng(shift)
        a = rng.integers(-(1 << 29), 1 << 29, size=512)
        c = rng.integers(-(1 << 29), 1 << 29, size=512)
        got = limb.mul_shift30(
            jnp.asarray(a, jnp.int32), jnp.asarray(c, jnp.int32), shift
        )
        from blackman_harris_win.core.fixedpoint import wrap as pywrap

        for i in range(512):
            want = pywrap((int(a[i]) * int(c[i])) >> shift, 32)
            assert int(got[i]) == want, (shift, int(a[i]), int(c[i]))


class TestCosDatapaths:
    @pytest.mark.parametrize("pw,w", [(10, 16), (12, 24), (14, 30)])
    def test_cos_i32_vs_golden(self, pw, w):
        ph = np.unique(
            np.concatenate(
                [np.arange(0, 1 << pw, max(1, (1 << pw) // 256)),
                 np.array([0, (1 << (pw - 2)) - 1, 1 << (pw - 2),
                           (1 << (pw - 1)), (1 << pw) - 1])]
            )
        )
        c = np.asarray(_cos_i32(jnp.asarray(ph, jnp.int32), pw, w))
        for i, p in enumerate(ph):
            assert int(c[i]) == golden.cordic_hls(int(p), pw, w)[0], (pw, w, p)

    @pytest.mark.parametrize("pw,w", [(12, 32), (26, 32)])
    def test_cos_wide4_vs_golden(self, pw, w):
        from blackman_harris_win.kernels.pallas.window_kernel import _cos_wide4

        ph = np.unique(
            np.concatenate(
                [np.arange(0, 1 << pw, max(1, (1 << pw) // 512)),
                 np.array([0, 1, (1 << (pw - 2)), (1 << (pw - 1)) - 1,
                           1 << (pw - 1), (3 << (pw - 2)), (1 << pw) - 1])]
            )
        )
        c = np.asarray(_cos_wide4(jnp.asarray(ph, jnp.int32), pw, w))
        for i, p in enumerate(ph):
            assert int(c[i]) == golden.cordic_hls(int(p), pw, w)[0], (pw, w, p)

    def test_cos_wide4_rejects_narrow(self):
        from blackman_harris_win.kernels.pallas.window_kernel import _cos_wide4

        with pytest.raises(ValueError):
            _cos_wide4(jnp.arange(4, dtype=jnp.int32), 10, 31)

    @pytest.mark.parametrize("pw,w", [(12, 32), (26, 32), (10, 31)])
    def test_cos_wide_vs_golden(self, pw, w):
        ph = np.unique(
            np.concatenate(
                [np.arange(0, 1 << pw, max(1, (1 << pw) // 128)),
                 np.array([0, 1, (1 << (pw - 1)) - 1, 1 << (pw - 1),
                           (1 << pw) - 1])]
            )
        )
        c = np.asarray(_cos_wide(jnp.asarray(ph, jnp.int32), pw, w))
        for i, p in enumerate(ph):
            assert int(c[i]) == golden.cordic_hls(int(p), pw, w)[0], (pw, w, p)


class TestWindowValues:
    @pytest.mark.parametrize(
        "name,pw,w",
        [
            ("bh4", 12, 17),
            ("bh7", 12, 24),   # wide product, narrow state
            ("bh7", 12, 32),   # wide state + wide product
            ("bh7", 26, 32),   # 64M regime
            ("hann", 10, 24),  # includes the reference wrap quirk sample
            ("bh5", 11, 20),
        ],
    )
    def test_matches_jnp_reference(self, name, pw, w):
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get(name).quantized(w)
        step = max(1, (1 << pw) // 512)
        n = np.arange(0, 1 << pw, step)
        got = np.asarray(window_values(jnp.asarray(n, jnp.int32), q, spec))
        want = np.asarray(kw.window_samples(n, q, spec)).astype(np.int32)
        np.testing.assert_array_equal(got, want)

    def test_saturate_mode(self):
        spec = WindowSpec(10, 24, overflow="saturate")
        q = catalog.get("hann").quantized(24)
        got = np.asarray(window_values(jnp.asarray([512], jnp.int32), q, spec))
        assert int(got[0]) == 2**23 - 1
