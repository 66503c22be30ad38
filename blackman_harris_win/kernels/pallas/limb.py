"""Two-limb int32 arithmetic for >32-bit fixed-point state on int32 lanes.

With x64 off (the production regime) there are no int64 lanes; wide state
(the 34-bit ap_int<W+2> CORDIC registers at W=32, or the 48-bit cordic_dds48
state) is carried as (hi, lo) int32 pairs with radix 2^24:
``value = hi * 2^24 + lo``, ``lo in [0, 2^24)``, hi signed.

This is the moral equivalent of the reference's wide multipliers built from
two cascaded DSP48s with a 17-bit partial-product shift
(``src/mults/mlt35x25_dsp48e1.vhd:81-127``): wide arithmetic decomposed onto
narrow hardware units, carries rippled explicitly.

All shift amounts are Python-static (loop-unrolled), so every branch below
resolves at trace time.
"""

from __future__ import annotations

import jax.numpy as jnp

L = 24
MASK = (1 << L) - 1


def const(v: int, iw: int) -> tuple[int, int]:
    """Split a Python int (two's complement value of iw bits) into static
    (hi, lo) int constants."""
    from ...core.fixedpoint import wrap as pywrap

    v = pywrap(v, iw)
    return (v >> L, v & MASK)


def splat(c: tuple[int, int], shape, dtype=jnp.int32):
    return (jnp.full(shape, c[0], dtype), jnp.full(shape, c[1], dtype))


def from_int32(v):
    """Lift an int32 array (value fits in 32 bits) to two-limb."""
    return (v >> L, v & MASK)


def to_int32(a):
    """Low 32 bits of the value (int32 wrap) — the final word when iw<=32
    output slicing already happened."""
    return (a[0] << L) + a[1]


def add(a, b):
    s = a[1] + b[1]
    return (a[0] + b[0] + (s >> L), s & MASK)


def sub(a, b):
    s = a[1] - b[1]
    return (a[0] - b[0] + (s >> L), s & MASK)


def neg(a):
    s = -a[1]
    return (-a[0] + (s >> L), s & MASK)


def shr(a, k: int):
    """Arithmetic shift right by static k (sign extends from hi)."""
    if k == 0:
        return a
    if k < L:
        lo = ((a[1] >> k) | (a[0] << (L - k))) & MASK
        hi = a[0] >> k
    else:
        lo = (a[0] >> min(k - L, 31)) & MASK
        hi = a[0] >> 31  # pure sign for k >= L (hi holds iw-L <= 24 bits)
    return (hi, lo)


def shl(a, k: int):
    """Shift left by static k <= 31 (caller wraps afterwards)."""
    if k == 0:
        return a
    if k >= 32:
        raise ValueError("shl supports k <= 31")
    if k < L:
        lo = (a[1] << k) & MASK
        hi = (a[0] << k) | (a[1] >> (L - k))
    else:
        lo = jnp.zeros_like(a[1])
        hi = (a[0] << k) + (a[1] << (k - L))
    return (hi, lo)


def wrap(a, iw: int):
    """Two's-complement wrap to iw bits (iw in (24, 56]): wraps hi to iw-24
    bits; lo untouched."""
    s = 32 - (iw - L)
    return ((a[0] << s) >> s, a[1])


def where(c, a, b):
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]))


def is_neg(a):
    """Sign test; valid after wrap()."""
    return a[0] < 0


def mul_shift30(a, c, shift: int):
    """Exact ``(a * c) >> shift`` for int32 a, c with |a|,|c| < 2^30 and
    28 <= shift <= 32, result fitting int32 (mod 2^32 on overflow — matching
    the reference's final win_t wrap).

    15-bit-limb decomposition; every partial product fits int32:
      a = a1*2^15 + a0,  c = c1*2^15 + c0  (a0, c0 unsigned 15-bit)
      a*c = a1*c1*2^30 + (a1*c0 + a0*c1)*2^15 + a0*c0
    Floor-exact for the shift (proof: carry layering, each stage < 2^15
    residual).  This is the int32-lane analogue of mlt35x27_dsp48e2's two-DSP
    partial-product cascade (src/mults/mlt35x27_dsp48e2.vhd:61-92).
    """
    a1, a0 = a >> 15, a & 0x7FFF
    c1, c0 = c >> 15, c & 0x7FFF
    t = a1 * c0 + a0 * c1 + ((a0 * c0) >> 15)
    hi30 = a1 * c1 + (t >> 15)  # == (a*c) >> 30
    if shift == 30:
        return hi30
    if shift > 30:
        return hi30 >> (shift - 30)
    # shift < 30: need low bits back; r = bits 15..29 of (t mod 2^15 <<15 | low)
    low15 = (a0 * c0) & 0x7FFF
    mid15 = t & 0x7FFF
    # value = hi30*2^30 + mid15*2^15 + low15
    return (hi30 << (30 - shift)) + ((mid15 << 15 | low15) >> shift)


def _mul_parts30(a, c):
    """(hi, rem) with a*c == hi*2^30 + rem, rem in [0, 2^30)."""
    a1, a0 = a >> 15, a & 0x7FFF
    c1, c0 = c >> 15, c & 0x7FFF
    t = a1 * c0 + a0 * c1 + ((a0 * c0) >> 15)
    hi = a1 * c1 + (t >> 15)
    rem = ((t & 0x7FFF) << 15) | ((a0 * c0) & 0x7FFF)
    return hi, rem


def mul_shift_rh(a_int: int, c, w: int):
    """Exact ``(rh, rl)`` with ``rh = (a_int * c) >> (w - 1)`` and
    ``rl = bit (w - 2) of (a_int * c)``, for w in {31, 32}, a static
    coefficient ``|a_int| < 2^(w-1)`` and int32 lanes ``|c| <~ 2^(w-2)``.

    This is the RTL window product slice (``src/bh_win_3term.vhd:260-267``:
    ``mult_p(2W-2 downto W-2)``) split as (r >> 1, r & 1) so the
    round-half-up ``rh + rl`` never materializes the (w+1)-bit slice r
    itself — r can reach +-2^(w-1)·(1+eps) which would alias an int32 at
    w = 32.  Derivation: a = 2·ah + e, p = 2·Q + e·c with Q = ah·c
    decomposed by :func:`_mul_parts30`; then with S = remQ + ((e·c) >> 1),
    ``p >> (w-1) = hiQ + (S >> 30)`` and ``bit(w-2) of p = bit 29 of S``
    (exact for all signs; |S| < 2^31).
    """
    if w == 31:
        # |a| < 2^30, |c| <= 2^29·(1+eps): _mul_parts30 bounds hold.
        hi, rem = _mul_parts30(jnp.int32(a_int), c)
        return hi, (rem >> 29) & 1
    if w != 32:
        raise ValueError("mul_shift_rh supports w in {31, 32}")
    ah, e = a_int >> 1, a_int & 1
    hi_q, rem_q = _mul_parts30(jnp.int32(ah), c)
    s = rem_q + (c >> 1) if e else rem_q
    return hi_q + (s >> 30), (s >> 29) & 1


def mul_wide_parts31(a_int: int, c):
    """Exact ``(p31, b30)`` = ``((a_int * c) >> 31, bit 30 of a_int * c)``
    for a STATIC ``|a_int| < 2^31`` and int32 lanes ``|c| < 2^31``.

    Serves the full-scale Taylor-source window products at W = 32
    (cos amplitude 2^31 - 1), where both operands exceed
    :func:`_mul_parts30`'s bounds.  Both are halved (a = 2·ah + ea,
    c = 2·ch + ec) so the core multiply fits, and the dropped bits re-enter
    as exact additive terms:

        P = 4·Q + 2·M + ea·ec,   Q = ah·ch = hi·2^30 + rem,
        M = ah·ec + ea·ch  (|M| < 2^31),   T = rem + (M >> 1)  (|T| < 2^31)
        P = hi·2^32 + 4·T + em,  em = 2(M & 1) + ea·ec  in [0, 4)
        P >> 31 = 2·hi + (T >> 29);   bit30(P) = bit28(T)
    """
    ah, ea = a_int >> 1, a_int & 1
    ch, ec = c >> 1, c & 1
    hi, rem = _mul_parts30(jnp.int32(ah), ch)
    m = ec * jnp.int32(ah)
    if ea:
        m = m + ch
    t = rem + (m >> 1)
    return 2 * hi + (t >> 29), (t >> 28) & 1


def mul_small_shift(a, c, shift: int):
    """Exact ``(a * c) >> shift`` on int32 lanes for a NON-NEGATIVE small
    multiplier ``a < 2^20`` and ``|c| < 2^31``, with ``shift >= 20`` and the
    result fitting int32.

    This is the Taylor-correction MACC's product (``mpi * sin``,
    src/tay1_order.vhd:506-599: mpi = round(pi*2^(17-STAGE))*acnt < pi*2^18)
    at data widths 31/32 where ``mul_shift30``'s |c| < 2^30 bound fails.
    Splits a into 10-bit and c into 15-bit limbs; every partial product and
    carry layer fits int32 (|A1| < 2^26, |u| < 2^26 + 2^20):

        P = A1*2^25 + A0*2^15 + B1*2^10 + B0,  remainders layered in [0, 2^k)
    """
    if shift < 20:
        raise ValueError("mul_small_shift requires shift >= 20")
    a1, a0 = a >> 10, a & 1023
    ch, cl = c >> 15, c & 0x7FFF
    b0 = a0 * cl
    t = a1 * cl + (b0 >> 10)      # units 2^10
    u = a0 * ch + (t >> 5)        # units 2^15
    v = a1 * ch + (u >> 10)       # units 2^25
    if shift >= 25:
        return v >> (shift - 25)
    # 20 <= shift < 25: recover the sub-2^25 remainder R (non-negative)
    low15 = ((t & 31) << 10) | (b0 & 1023)
    r = ((u & 1023) << 15) | low15
    return (v << (25 - shift)) + (r >> shift)


def mulsub_shift30(a, c, b, d, round: bool = False, shift: int = 30):
    """Exact ``(a*c - b*d) >> shift`` (round-half-up with ``round=True``) for
    int32 inputs with |.| < 2^30, shift in {30, 31, 32}, the result fitting
    int32.  One floor/round instead of two (halves the truncation noise of
    ``mul_shift30(a,c,30) - mul_shift30(b,d,30)`` — matters at the -180 dB
    spur budget; rounding centers it)."""
    if shift not in (30, 31):
        raise ValueError("mulsub_shift30 supports shift in {30, 31}")
    ha, ra = _mul_parts30(a, c)
    hb, rb = _mul_parts30(b, d)
    t, r = ha - hb, ra - rb  # value = t*2^30 + r, |r| < 2^30 (int32-safe)
    if shift == 30:
        return t + ((r + (1 << 29) if round else r) >> 30)
    # shift == 31: (t*2^30 + r') >> 31 == (t + (r' >> 30)) >> 1 exactly,
    # because the sub-2^30 remainder of r' can never flip the final bit.
    if round:
        r = r + (1 << 30)  # r' in (0, 2^31): int32-safe
    return (t + (r >> 30)) >> 1
