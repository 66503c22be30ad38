"""Native C++ golden library: dense-sweep cross-validation of every engine.

The C++ oracle lets us check orders of magnitude more phases than the
Python scalar models: full 2^PW sweeps for every CORDIC flavor and window.
Chain of evidence: C++ == Python golden (spot) and C++ == JAX kernels
(dense), all bit-exact.
"""

import numpy as np
import pytest

from blackman_harris_win.core.config import CordicSpec, WindowSpec
from blackman_harris_win.kernels import cordic as kc
from blackman_harris_win.kernels import taylor as kt
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.model import golden
from blackman_harris_win.model import native
from blackman_harris_win.windows import catalog


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.build()


class TestNativeVsPythonGolden:
    def test_spot_checks(self):
        rng = np.random.default_rng(0)
        ns = rng.integers(0, 1 << 12, size=64)
        c, s = native.cordic_hls(ns, 12, 20)
        for i, n in enumerate(ns):
            gc, gs = golden.cordic_hls(int(n), 12, 20)
            assert (c[i], s[i]) == (gc, gs)
        c, s = native.cordic_dds48(ns, 12, 24)
        for i, n in enumerate(ns):
            gc, gs = golden.cordic_dds48(int(n), 12, 24)
            assert (c[i], s[i]) == (gc, gs)
        t_c, t_s = native.taylor_sincos(ns, 12, 16, 8)
        for i, n in enumerate(ns):
            gc, gs = golden.taylor_sincos(int(n), 12, 16, 8)
            assert (t_c[i], t_s[i]) == (gc, gs)


class TestNativeVsJaxDense:
    """Full-period sweeps (every phase) against the JAX kernels."""

    @pytest.mark.parametrize(
        "flavor,pw,w,kw_",
        [
            ("hls", 14, 16, {}),
            ("hls", 12, 32, {}),
            ("dds", 14, 18, {"precision": 2}),
            ("dds48", 14, 20, {}),
            ("scaled", 14, 16, {}),
        ],
    )
    def test_cordic_full_period(self, flavor, pw, w, kw_):
        n = np.arange(1 << pw)
        spec = CordicSpec(pw, w, flavor, kw_.get("precision", 1))
        jc, js = kc.cordic_sincos(n, spec)
        fn = {
            "hls": native.cordic_hls,
            "dds": lambda *a: native.cordic_dds(*a, kw_.get("precision", 1)),
            "dds48": native.cordic_dds48,
            "scaled": native.cordic_scaled,
        }[flavor]
        nc, ns_ = fn(n, pw, w)
        np.testing.assert_array_equal(np.asarray(jc, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(js, np.int64), ns_)

    @pytest.mark.parametrize("name,w", [("bh4", 17), ("bh7", 32), ("hann", 24)])
    def test_window_full_period(self, name, w):
        pw = 13
        n = np.arange(1 << pw)
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get(name).quantized(w)
        jw = np.asarray(kw.window_samples(n, q, spec), np.int64)
        nw = native.win_hls(n, q, pw, w)
        np.testing.assert_array_equal(jw, nw)

    def test_taylor_full_period(self):
        pw, w, ls = 14, 24, 10
        n = np.arange(1 << pw)
        jc, js = kt.taylor_sincos(n, pw, w, ls)
        nc, ns_ = native.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(np.asarray(jc, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(js, np.int64), ns_)

    def test_atan2_dense(self):
        rng = np.random.default_rng(5)
        x = rng.integers(-(1 << 15), 1 << 15, size=20000)
        y = rng.integers(-(1 << 15), 1 << 15, size=20000)
        ja = np.asarray(kc.cordic_atan2(y, x, 16, 18), np.int64)
        na = native.cordic_atan2(y, x, 16, 18)
        np.testing.assert_array_equal(ja, na)
