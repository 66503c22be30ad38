"""Outer-product window generation — the int fast mode.

The reference evaluates w[n] = a0 - a1*cos(phi) + a2*cos(2*phi) - ... by
running K-1 CORDIC pipelines at one sample per clock
(``src/bh_win_7term.vhd:200-423``).  This module replaces the per-sample
trig evaluation with the angle-addition identity over a split index — the
way FFT libraries build twiddle factors:

    n = h * 2^m + lo,   theta_k(n) = 2*pi*k*n / 2^pw
    cos(theta_k) = cos(A_k(h)) * cos(B_k(lo)) - sin(A_k(h)) * sin(B_k(lo))

with per-harmonic tables over h (2^(pw-m) entries) and lo (2^m entries)
host-computed as *exactly rounded* float64 values at amplitude 2^(w-2)
(0.5 LSB each).  The signed coefficients +-a_k are folded into the h-tables
(|a_k| < 2^30 after the 5/7-term headroom quantization,
hls/windows/win_function.cpp:349-355), so the whole K-term window collapses
to, per sample,

    w[n] = a0 + sum_k (CH'_k[h] * CL_k[lo] - SH'_k[h] * SL_k[lo]) >> 30

— one exact combined multiply-subtract-shift (``limb.mulsub_shift30``) per
harmonic, all dense rank-1 broadcasts, **no gathers, no iteration loop**:
~28 int32 ops per harmonic against ~380 for the two-limb radix-4 CORDIC.

Accuracy: per harmonic, table rounding (0.5 LSB each of 4 terms, scaled by
|a_k| <= 0.36 resp. 1.0) plus one floor -> < 2 LSB; across 7 terms < ~8 LSB
worst-case at 2^(w-2).  NOT bit-exact vs the CORDIC datapath (the
reference's own TAYLOR SIN_TYPE isn't either); the acceptance contract is
spectral: BH-7 W=32 holds its published -180 dB floor with margin
(tests/test_fastwin.py), the reference's own validation methodology
(math/window_test.m, SURVEY.md §4.3).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import WindowSpec
from .pallas.limb import mulsub_shift30

DEFAULT_SPLIT = 11  # lo axis 2^11 = 2048 lanes; h table 2^(pw-11)


@lru_cache(maxsize=8)
def _tables(coeffs_q: tuple, pw: int, m: int):
    """(hi_tabs, lo_tabs, guard): hi (K-1, 2^(pw-m), 2) int32 with
    +-a_k * 2^guard folded; lo (K-1, 2^m, 2) int32 at amplitude 2^30 - 1 —
    full int32 headroom regardless of data_width, so
    (hi*lo) >> (30+guard) = a_k*cos directly at the coefficient scale (the
    HLS ``(a_k*c_k) >> (NWIDTH-2)`` step, win_function.cpp:368-373, in
    relative arithmetic).  Exact float64 rounding (all magnitudes < 2^31,
    well inside float64's 53-bit mantissa).  guard=1 when the coefficients
    leave headroom (|a_k| < 2^29) — halves the hi-table rounding error, the
    dominant spur source at the -180 dB floor."""
    amp = 2.0**30 - 1.0
    nh, nl = 1 << (pw - m), 1 << m
    ks = np.arange(1, len(coeffs_q))
    sgn = np.where(ks % 2 == 1, -1.0, 1.0)
    amax = max(abs(int(c)) for c in coeffs_q[1:])
    guard = 1 if amax < (1 << 29) else 0

    h = np.arange(nh)
    # theta_hi = 2*pi*k*h*2^m/2^pw = 2*pi*(k*h mod nh)/nh  (exact reduction)
    kh = np.mod(np.outer(ks, h), nh)
    ang_h = (2.0 * math.pi / nh) * kh
    a = np.array([float(int(c)) * 2.0**guard for c in coeffs_q[1:]])[:, None]
    ch = np.floor(sgn[:, None] * a * np.cos(ang_h) + 0.5).astype(np.int64)
    sh = np.floor(sgn[:, None] * a * np.sin(ang_h) + 0.5).astype(np.int64)
    hi = np.stack([ch, sh], axis=-1).astype(np.int32)

    lo = np.arange(nl)
    klo = np.mod(np.outer(ks, lo), 1 << pw)
    ang_l = (2.0 * math.pi / (1 << pw)) * klo
    cl = np.floor(amp * np.cos(ang_l) + 0.5).astype(np.int64)
    sl = np.floor(amp * np.sin(ang_l) + 0.5).astype(np.int64)
    lo_t = np.stack([cl, sl], axis=-1).astype(np.int32)
    return hi, lo_t, guard


def window_block_outer(
    n0, rows: int, coeffs_q, spec: WindowSpec, m: int = DEFAULT_SPLIT
):
    """Window samples [n0, n0 + rows*2^m) as a (rows * 2^m,) int32 array.

    ``n0`` may be traced (dynamic block offset) but must be a multiple of
    2^m with the block inside one period: 0 <= n0, n0 + rows*2^m <= 2^pw.
    HLS accumulate semantics with the ideal-rounded outer-product cosine.
    """
    pw, w = spec.phase_width, spec.data_width
    if m >= pw:
        raise ValueError("split m must be < phase_width")
    coeffs_q = tuple(int(c) for c in coeffs_q)
    amax = max(abs(c) for c in coeffs_q)
    if amax >= 1 << 30:
        raise ValueError(
            "outer-product path needs |coeffs| < 2^30 (use the 5/7-term "
            "headroom quantization, win_function.cpp:349-355)"
        )
    hi_np, lo_np, guard = _tables(coeffs_q, pw, m)
    hi_t, lo_t = jnp.asarray(hi_np), jnp.asarray(lo_np)
    nl = 1 << m

    h0 = jnp.asarray(n0, jnp.int32) >> m
    zero = jnp.int32(0)
    hi_blk = jax.lax.dynamic_slice(
        hi_t, (zero, h0, zero), (hi_t.shape[0], rows, 2)
    )  # (K-1, rows, 2)

    acc = jnp.full((rows, nl), coeffs_q[0], jnp.int32)
    for i in range(hi_t.shape[0]):
        chp = hi_blk[i, :, 0][:, None]
        shp = hi_blk[i, :, 1][:, None]
        cl = lo_t[i, :, 0][None, :]
        sl = lo_t[i, :, 1][None, :]
        acc = acc + mulsub_shift30(chp, cl, shp, sl, round=True, shift=30 + guard)

    if spec.overflow == "saturate" and w < 32:
        acc = jnp.clip(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    elif w < 32:
        sw = 32 - w
        acc = (acc << sw) >> sw
    return acc.reshape(rows * nl)
