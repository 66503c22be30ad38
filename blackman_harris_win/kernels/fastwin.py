"""Second-order-Taylor fast window path ("taylor2") — the -180 dB fast mode.

The reference itself ships a LUT+Taylor generator as the fast alternative to
CORDIC (``src/taylor_sincos.vhd`` + ``src/tay1_order.vhd``: quarter-wave ROM,
1st-order correction through wide DSP48 multipliers, sanctioned for
DATA_WIDTH >= 19 via ``mlt35x25/35x27``).  This module is the same idea
re-sized for the -180 dB regime (W=32): a 2^LS-entry quarter-wave ROM
at amplitude 2^(W-2) plus a SECOND-order correction

    cos(t + d) = cos t - d*sin t - d^2/2 * cos t
    sin(t + d) = sin t + d*cos t - d^2/2 * sin t

evaluated entirely on int32 lanes with exact 15-bit-limb multiply-shifts
(``kernels/pallas/limb.py:mul_shift30`` — the int32-lane analogue of the cascaded
DSP48 wide multipliers, src/mults/mlt35x27_dsp48e2.vhd:61-92).

Accuracy (LS=12, W=32): truncation of the 3rd-order term <= 2^-3.6 LSB,
ROM rounding 0.5 LSB, phase-constant rounding < 2^-10 LSB (split-constant
d = acnt*P_hi + (acnt*P_lo >> 12)), multiply-shift floors <= 2 LSB -> total
|cos error| <= ~3 LSB at amplitude 2^30.  NOT bit-exact vs the CORDIC path
(neither is the reference's TAYLOR SIN_TYPE vs its CORDIC cores); validated
spectrally: BH-7 W=32 keeps its published -180 dB sidelobe floor
(tests/test_fastwin.py).

Why it's fast: per harmonic, one 2-word gather + 4 limb multiply-shifts
(~45 int32 ops) replaces 31 two-limb CORDIC iterations (~380 ops).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..core.config import WindowSpec
from .pallas.limb import mul_shift30

# Default quarter-wave ROM depth: 2^12 x 2 x int32 = 32 KiB (cache-resident).
DEFAULT_LUT_SIZE = 12


@lru_cache(maxsize=16)
def _rom_q(lut_size: int, data_width: int) -> np.ndarray:
    """Quarter-wave (cos, sin) ROM at amplitude 2^(data_width-2) - 1 — the
    CORDIC flavors' amplitude (hls/windows/win_function.cpp:130: outputs are
    >> 2 of the W-scaled state), so taylor2 drops into the same window
    product/accumulate datapath as the CORDIC paths."""
    n = 1 << lut_size
    ang = np.arange(n) * (math.pi / (2.0 * n))
    amp = 2.0 ** (data_width - 2) - 1.0
    cos_e = np.floor(amp * np.cos(ang) + 0.5).astype(np.int64)
    sin_e = np.floor(amp * np.sin(ang) + 0.5).astype(np.int64)
    return np.stack([cos_e, sin_e], axis=-1).astype(np.int32)


def _phase_consts(pw: int, ls: int):
    """Split fixed-point representation of the per-residual-count angle.

    d ~= delta * 2^S with S = ls + 29: for every residual width
    rb = pw-2-ls, P = (pi/2)*2^(29-rb) ~= 2^(29.65-rb), so
    d_max < 2^rb * P ~= 2^29.65 < 2^30 — safe for mul_shift30's |a| < 2^30
    domain at any pw.  P is split into an integer part and a 12-bit
    fractional part so the constant-rounding error stays << 1 output LSB.
    """
    rb = pw - 2 - ls
    s = ls + 29
    p_exact = (math.pi / 2.0) * (2.0 ** (29 - rb))
    p_hi = int(math.floor(p_exact))
    p_lo = int(math.floor((p_exact - p_hi) * 4096.0 + 0.5))
    return s, p_hi, p_lo, rb


def cos_sin_taylor2(p, pw: int, w: int, ls: int = DEFAULT_LUT_SIZE):
    """(cos, sin) at integer phases ``p`` (period 2^pw), amplitude
    2^(w-2)-1, int32 lanes only.  w <= 32; error <= ~3 LSB (see module doc).
    """
    if w > 32:
        raise ValueError("taylor2 path supports data_width <= 32")
    if ls > 14:
        raise ValueError("lut_size > 14 would overflow the d-scale headroom")
    p = jnp.asarray(p, jnp.int32) & ((1 << pw) - 1)
    q = p >> (pw - 2)
    ph = p & ((1 << (pw - 2)) - 1)

    rom = jnp.asarray(_rom_q(ls, w))
    rb = pw - 2 - ls

    if rb <= 0:
        addr = ph if rb == 0 else ph << (-rb)
        ent = rom[addr]
        mc, ms = ent[..., 0], ent[..., 1]
    else:
        addr = ph >> rb
        acnt = ph & ((1 << rb) - 1)
        ent = rom[addr]
        c0, s0 = ent[..., 0], ent[..., 1]

        s, p_hi, p_lo, _ = _phase_consts(pw, ls)
        # d = delta * 2^s, exact to ~2^-12 counts (acnt*p_lo < 2^(rb+12))
        d = acnt * p_hi
        if p_lo and rb + 12 <= 31:
            d = d + ((acnt * p_lo) >> 12)

        # e = delta^2 * 2^(2s-30); dh truncation contributes < 2^-7 LSB
        dh = d >> 15
        e = dh * dh

        # first-order: -+ d*{sin,cos} >> s; second-order: - e*{cos,sin}/2
        t1s = mul_shift30(d, s0, s)
        t1c = mul_shift30(d, c0, s)
        t2c = mul_shift30(e, c0, 2 * s - 29)
        t2s = mul_shift30(e, s0, 2 * s - 29)
        mc = c0 - t1s - t2c
        ms = s0 + t1c - t2s

    c = jnp.where(q == 0, mc, jnp.where(q == 1, -ms, jnp.where(q == 2, -mc, ms)))
    sn = jnp.where(q == 0, ms, jnp.where(q == 1, mc, jnp.where(q == 2, -ms, -mc)))
    return c, sn


def window_values_fast(n, coeffs_q, spec: WindowSpec):
    """Quantized cosine-sum window at int32 indices ``n`` via the taylor2
    generators.  HLS accumulate semantics (w[n] = a0 - m1 + m2 - ...,
    m_k = (a_k * cos_k) >> (W-2), hls/windows/win_function.cpp:361-375) with
    the ideal-rounded taylor2 cosine in place of the CORDIC cosine.
    """
    if spec.rounding != "hls":
        raise NotImplementedError("taylor2 implements HLS rounding")
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    coeffs_q = tuple(int(c) for c in coeffs_q)
    amax = max(abs(c) for c in coeffs_q)
    if amax >= 1 << 30:
        raise ValueError(
            "taylor2 window path needs |coeffs| < 2^30 (5/7-term headroom "
            "quantization, win_function.cpp:349-355)"
        )
    mask = (1 << pw) - 1
    wide_prod = (amax.bit_length() + (w - 2) + 1) > 31

    n = jnp.asarray(n, jnp.int32)
    acc = jnp.full(n.shape, coeffs_q[0], jnp.int32)
    for k in range(1, len(coeffs_q)):
        c, _ = cos_sin_taylor2((k * n) & mask, pw, w, ls)
        if wide_prod:
            m = mul_shift30(jnp.int32(coeffs_q[k]), c, w - 2)
        else:
            m = (coeffs_q[k] * c) >> (w - 2)
        acc = acc - m if k % 2 == 1 else acc + m

    if spec.overflow == "saturate" and w < 32:
        return jnp.clip(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    if w < 32:
        sw = 32 - w
        return (acc << sw) >> sw
    return acc  # w == 32: int32 wrap IS the win_t cast
