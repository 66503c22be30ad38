"""Vectoring-mode CORDIC (atan2): bit-exact vs golden + convention checks."""

import math

import numpy as np
import pytest

from blackman_harris_win.kernels.cordic import atan2_fixed, cordic_atan2
from blackman_harris_win.model import golden


def _vectors(iw, count=400, seed=0, r_min=None):
    # r_min: angular error of the datapath scales ~1/r (one's-complement
    # abs + truncated shifts), so accuracy tests draw from the realistic
    # operating range; bit-exactness tests may pass small r explicitly.
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_min or 100, (1 << (iw - 2)) - 1, size=count)
    th = rng.uniform(-math.pi, math.pi, size=count)
    x = np.round(r * np.cos(th)).astype(np.int64)
    y = np.round(r * np.sin(th)).astype(np.int64)
    return x, y


class TestBitExact:
    @pytest.mark.parametrize("iw,aw,p", [(16, 16, 1), (20, 24, 1), (16, 18, 3)])
    def test_matches_scalar_model(self, iw, aw, p):
        x, y = _vectors(iw)
        out = np.asarray(cordic_atan2(y, x, iw, aw, p))
        for i in range(len(x)):
            g = golden.cordic_atan2(int(y[i]), int(x[i]), iw, aw, p)
            assert int(out[i]) == g, (iw, aw, p, int(x[i]), int(y[i]))

    def test_axis_vectors(self):
        # exact axes exercise the quadrant edges
        iw = aw = 16
        for x, y in [(1000, 0), (0, 1000), (-1000, 0), (0, -1000), (1, 1)]:
            out = int(np.asarray(cordic_atan2([y], [x], iw, aw))[0])
            g = golden.cordic_atan2(y, x, iw, aw)
            assert out == g


class TestReferenceConvention:
    """Pin the reference's (non-standard) quadrant convention:
    Q1 -> -theta, Q2 -> pi-theta, Q3 -> pi/2-theta, Q4 -> theta-3pi/2."""

    def test_quadrant_formulas(self):
        iw = aw = 16
        sc = 2.0 ** (aw - 1) / math.pi
        for deg, formula in [
            (30, lambda t: -t),
            (120, lambda t: math.pi - t),
            (210, lambda t: math.pi / 2 - t),
            (300, lambda t: t - 3 * math.pi / 2),
        ]:
            th = math.radians(deg)
            x = round(9000 * math.cos(th))
            y = round(9000 * math.sin(th))
            out = int(np.asarray(cordic_atan2([y], [x], iw, aw))[0])
            want = formula(th) * sc
            assert abs(out - want) < 16, (deg, out, want)


class TestAtan2Fixed:
    """The corrected variant returns standard atan2(y,x), pi == 2^(AW-1)."""

    @pytest.mark.parametrize("aw", [16, 20, 24])
    def test_matches_float_atan2(self, aw):
        iw = min(aw, 20)
        x, y = _vectors(iw, count=600, seed=aw, r_min=1 << (iw - 4))
        out = np.asarray(atan2_fixed(y, x, iw, aw), np.float64)
        want = np.arctan2(y, x) * 2.0 ** (aw - 1) / math.pi
        # wrap-aware diff
        d = (out - np.round(want)) % (1 << aw)
        d = np.where(d > (1 << (aw - 1)), d - (1 << aw), d)
        # error is input-quantization-limited: ~1 input LSB at radius r_min
        # subtends 2^(aw-1)/(pi * r_min) output LSBs
        lsb = 2.0 ** (aw - 1) / (math.pi * (1 << (iw - 4)))
        assert np.abs(d).mean() < max(8, lsb), np.abs(d).mean()
        assert np.abs(d).max() < max(64, 8 * lsb)

    def test_demod_usable(self):
        # phase-difference demod: d/dt of atan2 along a chirp recovers the
        # instantaneous frequency
        aw = 20
        n = np.arange(2048)
        f = 0.01 + 0.00002 * n
        ph = 2 * math.pi * np.cumsum(f)
        x = np.round(30000 * np.cos(ph)).astype(np.int64)
        y = np.round(30000 * np.sin(ph)).astype(np.int64)
        a = np.asarray(atan2_fixed(y, x, 17, aw), np.float64)
        dphi = np.diff(a)
        dphi = (dphi + (1 << (aw - 1))) % (1 << aw) - (1 << (aw - 1))
        f_est = dphi / (1 << aw)
        err = np.abs(f_est - f[1:])
        assert err.mean() < 2e-4, err.mean()
