"""Quantized cosine-sum window generation on int32 lanes.

The reference's K-1 parallel CORDIC cores + multiplier + adder tree
(src/bh_win_7term.vhd:200-423) as one elementwise jnp computation over the
sample axis; under ``jit`` XLA fuses iota -> CORDIC -> accumulate into a
single loop fusion.  It serves every configuration whose products or
CORDIC state exceed 32 bits while x64 is off (the production regime), and
is bit-exact vs ``kernels/window.py`` (itself bit-exact vs
``model/golden.py``).

Datapaths:

- ``_cos_i32``: single-limb int32 CORDIC for internal width W+2 <= 32.
- ``_cos_wide``: two-limb (radix 2^24) CORDIC for W+2 in (32, 48] — the
  -180 dB BH-7 W=32 regime — with 15-bit-limb wide products
  (``limb.mul_shift30``), the analogue of the reference's cascaded
  DSP48 wide multipliers.
- ``_cos_wide4``: the radix-4 variant for W+2 == 34 exactly.

Phases are closed-form (k*n) mod 2^PHI, so generation needs no inputs
beyond the sample indices: it is communication-free and streams at
arbitrary window length (16 .. 64M+).
"""

from __future__ import annotations

import jax.numpy as jnp

from ...core.config import WindowSpec
from ...core.luts import GAIN48_QUARTER, hls_atan_lut as _hls_luts
from . import limb


def _quadrant_and_z0(n, pw: int, w: int):
    """Shared phase front-end: quadrant bits and the things init_z is built
    from.  n: int32 sample indices (non-negative, any value; reduced mod
    2^pw)."""
    if pw > 31:
        raise ValueError("int32-lane window kernels support phase_width <= 31")
    mask = (1 << pw) - 1
    un = n & mask
    q = un >> (pw - 2)
    # + int32(-2^pw) instead of - (1 << pw): the constant must not
    # overflow the int32 weak type at pw == 31
    sphi = jnp.where(un >> (pw - 1) != 0, un + jnp.int32(-(1 << pw)), un)
    init_t = sphi & ~(0x3 << (pw - 2))
    return q, init_t


def _cos_i32(n, pw: int, w: int):
    """Single-limb HLS-flavor CORDIC cosine (internal width w+2 <= 32).
    Bit-exact vs kernels.cordic.cordic_hls."""
    iw = w + 2
    s = 32 - iw
    wrap_iw = (lambda v: (v << s) >> s) if s else (lambda v: v)
    luts = _hls_luts(w)
    gain = GAIN48_QUARTER >> (46 - w)

    q, init_t = _quadrant_and_z0(n, pw, w)
    if pw - 1 < w:
        z = wrap_iw(init_t << (w - pw + 2))
    else:
        z = wrap_iw((init_t >> (pw - w)) << 2)

    # d = (z>>31)|1 is -1 when z<0; "z<0: x += y>>k" becomes x -= d*(y>>k),
    # y += d*(x>>k), z -= d*lut[k].  Iteration 0 specialized (y0 = 0).
    nb = jnp.iinfo(jnp.int32).bits
    d = (z >> (nb - 1)) | 1
    x = jnp.full(n.shape, gain, jnp.int32)
    y = wrap_iw(d * gain)
    z = wrap_iw(z - d * luts[0])
    for k in range(1, w):
        d = (z >> (nb - 1)) | 1
        ys, xs = y >> k, x >> k
        x, y = wrap_iw(x - d * ys), wrap_iw(y + d * xs)
        if k < w - 1:
            z = wrap_iw(z - d * luts[k])

    out_c, out_s = x >> 2, y >> 2
    c = jnp.where(
        q == 0, out_c, jnp.where(q == 1, -out_s, jnp.where(q == 2, -out_c, out_s))
    )
    sw = 32 - w
    return (c << sw) >> sw  # win_t wrap


def _cos_wide(n, pw: int, w: int):
    """Two-limb HLS-flavor CORDIC cosine for internal width w+2 in (32, 48].
    Returns int32 (w <= 32 output)."""
    iw = w + 2
    luts = [limb.const(v, iw) for v in _hls_luts(w)]
    gain = limb.const(GAIN48_QUARTER >> (46 - w), iw)

    q, init_t = _quadrant_and_z0(n, pw, w)  # init_t: int32, |.| < 2^(pw-1)
    if pw - 1 < w:
        z = limb.wrap(limb.shl(limb.from_int32(init_t), w - pw + 2), iw)
    else:
        z = limb.wrap(limb.shl(limb.from_int32(init_t >> (pw - w)), 2), iw)

    x = limb.splat(gain, n.shape)
    y = limb.splat((0, 0), n.shape)
    for k in range(w):
        neg = limb.is_neg(z)
        ys, xs = limb.shr(y, k), limb.shr(x, k)
        x_new = limb.where(neg, limb.add(x, ys), limb.sub(x, ys))
        y_new = limb.where(neg, limb.sub(y, xs), limb.add(y, xs))
        x, y = limb.wrap(x_new, iw), limb.wrap(y_new, iw)
        if k < w - 1:
            lk = limb.splat(luts[k], n.shape)
            z = limb.wrap(limb.where(neg, limb.add(z, lk), limb.sub(z, lk)), iw)

    out_c = limb.shr(x, 2)
    out_s = limb.shr(y, 2)
    c = limb.where(
        q == 0,
        out_c,
        limb.where(
            q == 1, limb.neg(out_s), limb.where(q == 2, limb.neg(out_c), out_s)
        ),
    )
    sw = 32 - w
    return (limb.to_int32(c) << sw) >> sw  # win_t wrap (w <= 32)


def _cos_wide4(n, pw: int, w: int):
    """Radix-4 two-limb HLS-flavor CORDIC cosine for internal width
    w+2 == 34 exactly — the -180 dB regime (w = 32).  The trick only works
    at 34 bits: h is the value's bits 2..33, so native int32 wraparound IS
    the 34-bit register wrap; narrower widths would need explicit h wraps
    (use the radix-2^24 path there).

    Representation: ``v = h*4 + l`` with h a *native int32* (so the 34-bit
    two's-complement wrap is free) and l in {0..3}.  Steering uses a
    multiply by d = +-1 instead of dual-branch selects, and the output
    ``x >> 2`` is simply h.  Bit-exact vs :func:`_cos_wide` / the golden
    model; ~1.5x fewer int32 ops per iteration.
    """
    iw = w + 2
    if iw != 34:
        raise ValueError("radix-4 path requires internal width == 34 (w=32)")
    luts = _hls_luts(w)
    gain = GAIN48_QUARTER >> (46 - w)

    q, init_t = _quadrant_and_z0(n, pw, w)
    # init_z's low 2 bits are always 0: both reference branches end in a
    # left-shift of >= 2 (win_function.cpp:92,95), so l = 0 and h carries
    # bits 2..33 (native int32 wrap == 34-bit wrap).
    if pw - 1 < w:
        zh = init_t << (w - pw)  # (init_t << (w-pw+2)) >> 2
    else:
        zh = init_t >> (pw - w)  # ((init_t >> (pw-w)) << 2) >> 2

    # Steering sign d = (zh>>31)|1 is -1 when z<0, +1 when z>=0; the hls
    # update "z<0: x += y>>k" therefore reads x -= d*(y>>k), y += d*(x>>k),
    # z -= d*lut[k].
    # Iteration 0 specialization: x0 = gain, y0 = 0, so x1 = x0,
    # y1 = +d*x0; z1 = z0 - d*lut[0] (lut[0] = 2^(w-1): low bits 0).
    d = (zh >> 31) | 1
    gh, gl = gain >> 2, gain & 3
    xh = jnp.full(n.shape, gh, jnp.int32)
    xl = jnp.full(n.shape, gl, jnp.int32)
    s2 = d * gl
    yh, yl = d * gh + (s2 >> 2), s2 & 3
    # z-fold: after iteration 0 the 34-bit residual fits ONE native int32
    # exactly — |z0| <= 2^32 and lut[0] = 2^31, so z1 = z0 -+ lut[0] lies in
    # [-2^31, 2^31 - 4]; thereafter |z_{k+1}| <= max(|z_k|, lut[k]) with
    # lut[1] < 2^29.3, so z never regrows past 2^31.  Every remaining
    # z-update is then a single multiply-subtract (luts[k] < 2^30 for
    # k >= 1) instead of the 2-limb carry chain.  Verified bit-exact vs the
    # golden model (full-period sweeps in tests/test_pallas.py).
    zs = (zh - d * (luts[0] >> 2)) << 2

    for k in range(1, w):
        d = (zs >> 31) | 1
        if k == 1:
            ysh = yh >> 1
            ysl = ((yh & 1) << 1) | (yl >> 1)
            xsh = xh >> 1
            xsl = ((xh & 1) << 1) | (xl >> 1)
        else:
            ysh = yh >> k
            ysl = (yh >> (k - 2)) & 3
            xsh = xh >> k
            xsl = (xh >> (k - 2)) & 3
        s1 = xl - d * ysl
        xh, xl = xh - d * ysh + (s1 >> 2), s1 & 3
        s2 = yl + d * xsl
        yh, yl = yh + d * xsh + (s2 >> 2), s2 & 3
        if k < w - 1:
            zs = zs - d * luts[k]

    # out = x >> 2 == h; quadrant fix on int32 (wrap at w bits afterwards)
    c = jnp.where(
        q == 0, xh, jnp.where(q == 1, -yh, jnp.where(q == 2, -xh, yh))
    )
    sw = 32 - w
    return (c << sw) >> sw if sw else c


def _rtl_term(coeff: int, c, w: int, full_scale_cos: bool = False):
    """One RTL product term: ``wrap(round_half_up_bit0(wrap((a_k * cos_k)
    >> (W-2), W+1)), W)`` (src/bh_win_3term.vhd:257-280) on int32 lanes.

    The (w+1)-bit slice r fits int32 for w <= 31 (|r| < 2^w); at the wide
    end, ``limb.mul_shift_rh`` / ``limb.mul_wide_parts31`` return
    (r>>1, r&1) directly so r itself is never materialized.
    ``full_scale_cos``: the TAYLOR source's 2^(w-1) amplitude (vs the CORDIC
    flavors' 2^(w-2)) — at w = 32 it exceeds mul_shift_rh's |c| bound and
    takes the halved-operand routine instead.
    """
    coeff = int(coeff)
    cos_bits = (w - 1) if full_scale_cos else (w - 2)
    prod_bits = abs(coeff).bit_length() + cos_bits + 1
    if prod_bits <= 31:
        r = (coeff * c) >> (w - 2)
        b = (r >> 1) + (r & 1)
    elif full_scale_cos and w == 32:
        rh, rl = limb.mul_wide_parts31(coeff, c)  # (P>>31, bit30) == (r>>1, r&1)
        b = rh + rl
    elif w <= 30:
        # |r| < 2^w <= 2^30: mul_shift30 is exact and alias-free here.
        r = limb.mul_shift30(jnp.int32(coeff), c, w - 2)
        b = (r >> 1) + (r & 1)
    else:
        rh, rl = limb.mul_shift_rh(coeff, c, w)
        b = rh + rl
    sw = 32 - w
    return (b << sw) >> sw if sw else b


def window_values_rtl(n, coeffs_q, spec: WindowSpec):
    """RTL (VHDL) rounding-contract window samples at int32 indices ``n``
    on int32 lanes only: cos from ``cordic_dds``
    (src/cordic_dds.vhd), product slice [2W-2:W-2] with round-half-up off
    bit 0, alternating adder tree in W+2 bits, final round-half-up off
    bit 1 (src/bh_win_3term.vhd:257-306); 2-term variant per
    src/hamming_win.vhd:194-231 (W+1-bit subtract, final round off bit 0).

    For w in {31, 32} the (w+2)-bit adder tree is carried radix-4 as
    (acc>>2 in a native int32, acc&3): the final output keeps only bits
    2..w+1 of the tree (+ the bit-1 round), so the int32 high word IS the
    (w+2)-bit register mod 2^w — the same trick as :func:`_cos_wide4`.
    """
    from .cordic_wide import cordic_dds_i32

    if spec.sin_type not in ("cordic", "taylor"):
        raise NotImplementedError("int32 RTL path supports CORDIC/TAYLOR")
    pw, w, p = spec.phase_width, spec.data_width, spec.precision
    coeffs_q = tuple(int(c) for c in coeffs_q)
    mask = (1 << pw) - 1
    nterms = len(coeffs_q)
    full_scale = spec.sin_type == "taylor"
    sw = 32 - w

    bs = []
    for k in range(1, nterms):
        if full_scale:
            # the reference doubles harmonic frequency by instantiating the
            # generator one phase bit narrower (src/bh_win_3term.vhd:221-233);
            if k not in (1, 2):
                raise ValueError("TAYLOR sin_type supports 2/3-term windows")
            from ..taylor import taylor_sincos

            pwk = pw - (k - 1)
            c, _ = taylor_sincos(n & ((1 << pwk) - 1), pwk, w, spec.lut_size)
            c = c.astype(jnp.int32)
        else:
            c, _ = cordic_dds_i32((k * n) & mask, pw, w, p)
        bs.append(_rtl_term(coeffs_q[k], c, w, full_scale))

    if nterms == 2:  # hamming_win.vhd:211-231 (W+1-bit subtract, rnd bit 0)
        a0, b = coeffs_q[0], bs[0]
        if w <= 31:
            pp = ((a0 - b) << (31 - w)) >> (31 - w)  # wrap to w+1 bits
            out = (pp >> 1) + (pp & 1)
        else:  # 33-bit pp as radix-2 (h = pp>>1 native int32, l = pp&0x1)
            t = (a0 & 1) - (b & 1)
            h = (a0 >> 1) - (b >> 1) + (t >> 1)
            out = h + (t & 1)  # wrap(rnd_half_up_bit0(pp), 32) == h + pp&1
        return (out << sw) >> sw if sw else out

    if w <= 30:  # W+2-bit tree fits int32
        acc = jnp.full(n.shape, coeffs_q[0], jnp.int32)
        for k, b in enumerate(bs, start=1):
            acc = acc - b if k % 2 == 1 else acc + b
        pp = (acc << (30 - w)) >> (30 - w)  # wrap to w+2 bits
        out = (pp >> 2) + ((pp >> 1) & 1)
    else:  # radix-4 tree: h = acc>>2 (int32, exact mod 2^w), l = acc&3
        a0 = coeffs_q[0]
        h = jnp.full(n.shape, a0 >> 2, jnp.int32)
        l = jnp.full(n.shape, a0 & 3, jnp.int32)
        for k, b in enumerate(bs, start=1):
            if k % 2 == 1:
                t = l - (b & 3)
                h = h - (b >> 2) + (t >> 2)
            else:
                t = l + (b & 3)
                h = h + (b >> 2) + (t >> 2)
            l = t & 3
        # out = wrap((pp>>2) + ((pp>>1)&1), w); pp>>2 == h (mod 2^w),
        # (pp>>1)&1 == bit 1 of acc == (l>>1)&1.
        out = h + ((l >> 1) & 1)
    return (out << sw) >> sw if sw else out


def window_values(n, coeffs_q, spec: WindowSpec):
    """Window samples at int32 indices ``n`` using int32-lane datapaths
    only.  Dispatches on
    ``spec.rounding`` (HLS or the VHDL "rtl" contract) and single-limb vs
    two-limb per the exact product/state widths.
    """
    if spec.rounding == "rtl":
        return window_values_rtl(n, coeffs_q, spec)
    pw, w = spec.phase_width, spec.data_width
    coeffs_q = tuple(int(c) for c in coeffs_q)
    amax = max(abs(c) for c in coeffs_q)
    mask = (1 << pw) - 1

    wide_state = (w + 2) > 32
    wide_prod = (amax.bit_length() + (w - 2) + 1) > 32
    if not wide_state:
        cos_fn = _cos_i32
    elif w + 2 == 34:
        cos_fn = _cos_wide4  # radix-4 fast path for the -180 dB regime
    else:
        cos_fn = _cos_wide

    # At w == 32 the int32 accumulator IS the W-bit register, so "saturate"
    # needs wrap *tracking*: each step changes the true value by < 2^31, so
    # a signed overflow counter ov recovers true = acc + ov * 2^32 exactly,
    # and ov != 0 at the end means the exact accumulator left the W-bit
    # range (clamp).  Needed e.g. for shift-1 (31-magnitude-bit) coefficient
    # sets, where the CORDIC quadrant overshoot to 2^(w-2)+1
    # (hls cordic cos(0) = 0x40000001) pushes the peak one past full scale.
    track_ov = spec.overflow == "saturate" and w == 32
    acc = jnp.full(n.shape, coeffs_q[0], jnp.int32)
    ov = jnp.zeros(n.shape, jnp.int32) if track_ov else None
    for k in range(1, len(coeffs_q)):
        c = cos_fn((k * n) & mask, pw, w)
        if wide_prod:
            m = limb.mul_shift30(jnp.int32(coeffs_q[k]), c, w - 2)
        else:
            m = (coeffs_q[k] * c) >> (w - 2)
        t = -m if k % 2 == 1 else m
        res = acc + t
        if track_ov:
            # signed-overflow detect: sign(acc)==sign(t) != sign(res);
            # direction is acc's sign (+1 wrap-up, -1 wrap-down)
            of = (~(acc ^ t) & (acc ^ res)) >> 31
            ov = ov + jnp.where(of != 0, (acc >> 31) | 1, 0)
        acc = res

    if track_ov:
        imax = jnp.int32((1 << 31) - 1)
        imin = jnp.int32(-(1 << 31))
        return jnp.where(ov > 0, imax, jnp.where(ov < 0, imin, acc))
    if spec.overflow == "saturate" and w < 32:
        return jnp.clip(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    if w < 32:
        sw = 32 - w
        return (acc << sw) >> sw
    return acc  # w == 32: int32 wrap IS the win_t cast

