"""CORDIC kernels: bit-exact vs the scalar golden models + float accuracy.

Mirrors the reference's own acceptance style: hls/cordic/cordic_test.cpp:67-99
compares every phase against round(2^(NWIDTH-2) * sin/cos) with a mean-error
bound of 10 LSB.  Here the bound is asserted per flavor, plus 0-LSB equality
between the vectorized jnp kernels and the exact Python models.
"""

import math

import numpy as np
import pytest

from blackman_harris_win.core.config import CordicSpec
from blackman_harris_win.kernels import cordic as kc
from blackman_harris_win.model import golden


def _all_phases(pw, limit=4096):
    n = 1 << pw
    if n <= limit:
        return np.arange(n)
    step = n // limit
    base = np.arange(0, n, step)
    # always include quadrant boundaries and their neighbors
    qb = np.array([0, n // 4, n // 2, 3 * n // 4])
    extra = np.concatenate([qb, qb - 1, qb + 1, [n - 1]]) % n
    return np.unique(np.concatenate([base, extra]))


FLAVORS = [
    ("hls", dict()),
    ("cmodel", dict()),
    ("dds", dict(precision=1)),
    ("dds", dict(precision=3)),
    ("dds48", dict()),
    ("scaled", dict()),
]

GOLDEN = {
    "hls": golden.cordic_hls,
    "cmodel": golden.cordic_cmodel,
    "dds": golden.cordic_dds,
    "dds48": golden.cordic_dds48,
    "scaled": golden.cordic_scaled,
}


class TestBitExactVsGolden:
    @pytest.mark.parametrize("flavor,kw", FLAVORS)
    @pytest.mark.parametrize("pw,w", [(10, 16), (10, 24), (14, 12), (12, 18)])
    def test_matches_scalar_model(self, flavor, kw, pw, w):
        spec = CordicSpec(pw, w, flavor, kw.get("precision", 1))
        phases = _all_phases(pw, limit=1024)
        c, s = kc.cordic_sincos(phases, spec)
        c, s = np.asarray(c), np.asarray(s)
        for i, p in enumerate(phases):
            gc, gs = GOLDEN[flavor](int(p), pw, w, **kw)
            assert c[i] == gc, (flavor, pw, w, int(p), int(c[i]), gc)
            assert s[i] == gs, (flavor, pw, w, int(p), int(s[i]), gs)

    @pytest.mark.parametrize("pw,w", [(20, 32), (26, 32)])
    def test_wide_matches_scalar_model(self, pw, w):
        # int64-lane widths (the -180 dB regime)
        for flavor in ("hls", "dds48"):
            spec = CordicSpec(pw, w, flavor)
            phases = _all_phases(pw, limit=128)
            c, s = kc.cordic_sincos(phases, spec)
            for i, p in enumerate(phases):
                gc, gs = GOLDEN[flavor](int(p), pw, w)
                assert int(c[i]) == gc, (flavor, int(p))
                assert int(s[i]) == gs, (flavor, int(p))


class TestFloatAccuracy:
    """Reference acceptance: mean |err| < 10 LSB vs round(amp * cos/sin)
    (hls/cordic/cordic_test.cpp:93-98)."""

    @pytest.mark.parametrize(
        "flavor,kw,amp_shift,check_sin",
        [
            ("hls", dict(), 2, True),
            ("cmodel", dict(), 2, True),
            ("dds", dict(precision=1), 2, True),
            ("dds", dict(precision=4), 2, True),
            ("dds48", dict(), 2, False),  # reference sin-axis quirk
            ("scaled", dict(), 2, False),
        ],
    )
    @pytest.mark.parametrize("pw,w", [(10, 16), (12, 20), (10, 24)])
    def test_mean_error_bound(self, flavor, kw, amp_shift, check_sin, pw, w):
        spec = CordicSpec(pw, w, flavor, kw.get("precision", 1))
        n = 1 << pw
        phases = _all_phases(pw)
        c, s = kc.cordic_sincos(phases, spec)
        amp = 2.0 ** (w - amp_shift)
        th = 2 * math.pi * phases / n
        gold_c = np.round(amp * np.cos(th))
        errs = np.abs(np.asarray(c, dtype=np.float64) - gold_c)
        if check_sin:
            gold_s = np.round(amp * np.sin(th))
            errs = np.concatenate([errs, np.abs(np.asarray(s, np.float64) - gold_s)])
        assert errs.mean() < 10, (flavor, pw, w, errs.mean())

    def test_dds48_sin_axis_quirk(self):
        # DT_SIN of cordic_dds48 carries -sin (documented quirk);
        # DT_COS is the true cosine.
        spec = CordicSpec(12, 16, "dds48")
        phases = _all_phases(12)
        _, s = kc.cordic_sincos(phases, spec)
        th = 2 * math.pi * phases / (1 << 12)
        gold = np.round(2.0**14 * np.sin(th))
        err_neg = np.abs(np.asarray(s, np.float64) + gold).mean()
        err_pos = np.abs(np.asarray(s, np.float64) - gold).mean()
        assert err_neg < 10 < err_pos


class TestSpectralPurity:
    """Spectral acceptance (math/cordic_main.m:108-155): dithered |FFT|^2,
    normalized, sidelobe floor consistent with the '1 bit ~ 6 dB' rule."""

    @pytest.mark.parametrize("w,floor_db", [(12, -60), (16, -84), (24, -120)])
    def test_sidelobe_floor(self, w, floor_db):
        pw = 12
        n = 1 << pw
        spec = CordicSpec(pw, w, "hls")
        c, s = kc.cordic_sincos(np.arange(n), spec)
        sig = np.asarray(c, np.float64) + 1e-9 * np.random.default_rng(1).normal(
            size=n
        )
        spec_db = np.abs(np.fft.fft(sig)) ** 2
        spec_db = spec_db / spec_db.max()
        spec_db = 10 * np.log10(spec_db + 1e-30)
        # exclude the carrier bins (+-1) and DC
        mask = np.ones(n, bool)
        mask[[0, 1, n - 1]] = False
        assert spec_db[mask].max() < floor_db, spec_db[mask].max()
