"""Int32-lane datapaths for every wide CORDIC flavor.

The jnp reference flavors in ``kernels/cordic.py`` need int64 carriers when
the internal state exceeds 32 bits — ``cordic_dds48`` (48-bit state,
``src/cordic_dds48.vhd:57``), ``cordic_dds_scaled`` (SEL_SIZE widths up to 48,
``src/cordic_dds_scaled.vhd:100-107``), and ``cordic_dds``/``cordic_hls`` at
data_width >= 31.  Without x64 (the production regime) those carriers do
not exist; the functions here implement the same bit-level contracts on pure
int32 lanes, carrying wide state as radix-2^24 two-limb pairs
(``kernels/pallas/limb.py``) — the int32-lane analogue of the reference's cascaded
DSP48 wide datapath (``src/mults/mlt35x25_dsp48e1.vhd:81-127``).

Every function is bit-exact against ``model/golden.py`` and the native C++
oracle (full-period sweeps in ``tests/test_cordic_wide.py``), built from
static shifts with no dynamic control flow, and usable as a plain jnp
function.

Design: one representation-polymorphic lane layer (`_lane`) picks native
int32 ops for widths <= 32 and two-limb ops beyond, so the ``scaled`` flavor
can mix lane widths (x/y at SIZE bits, z at max(SIZE, PHASE_WIDTH) bits —
``src/cordic_dds_scaled.vhd:132-143``) without duplicating the iteration.
"""

from __future__ import annotations

import jax.numpy as jnp

from ...core.fixedpoint import wrap as pywrap
from ...core.luts import (
    GAIN48_HALF,
    GAIN48_QUARTER,
    LUT_ATAN_2PI,
    LUT_ATAN_PI,
    hls_atan_lut,
    scaled_internal_width,
)
from . import limb


class _I32Ops:
    """Native int32 lane for internal widths <= 32 (values wrapped to iw)."""

    def __init__(self, iw: int):
        if not 2 <= iw <= 32:
            raise ValueError(iw)
        self.iw = iw
        self._s = 32 - iw

    def const(self, v: int) -> int:
        return pywrap(v, self.iw)

    def splat(self, c: int, shape):
        return jnp.full(shape, c, jnp.int32)

    def lift(self, v):  # int32 array (value fits iw) -> lane
        return self.wrap(v)

    def wrap(self, a):
        s = self._s
        return (a << s) >> s if s else a

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def shr(self, a, k: int):
        return a >> k

    def shl_wrap(self, a, k: int):
        if k >= self.iw:
            return jnp.zeros_like(a)
        return self.wrap(a << k)

    def where(self, c, a, b):
        return jnp.where(c, a, b)

    def is_neg(self, a):
        return a < 0

    def shr_to_i32(self, a, k: int):
        """(value >> k) as plain int32 (caller guarantees it fits)."""
        return a >> k


class _LimbOps:
    """Two-limb radix-2^24 lane for internal widths in (32, 56]."""

    def __init__(self, iw: int):
        if not 32 < iw <= 56:
            raise ValueError(iw)
        self.iw = iw

    def const(self, v: int):
        return limb.const(v, self.iw)

    def splat(self, c, shape):
        return limb.splat(c, shape)

    def lift(self, v):
        return limb.from_int32(v)

    def wrap(self, a):
        return limb.wrap(a, self.iw)

    def add(self, a, b):
        return limb.add(a, b)

    def sub(self, a, b):
        return limb.sub(a, b)

    def shr(self, a, k: int):
        return limb.shr(a, k)

    def shl_wrap(self, a, k: int):
        # Chunked <=23-bit shifts with an iw-wrap between chunks: hi-limb
        # overflow past 2^32 is harmless (all limb ops are ring maps mod
        # 2^32 and wrap() keeps only iw-24 hi bits).
        while k > 0:
            s = min(k, 23)
            a = limb.wrap(limb.shl(a, s), self.iw)
            k -= s
        return limb.wrap(a, self.iw)

    def where(self, c, a, b):
        return limb.where(c, a, b)

    def is_neg(self, a):
        return limb.is_neg(a)

    def shr_to_i32(self, a, k: int):
        return limb.to_int32(limb.shr(a, k))


def _lane(iw: int):
    return _I32Ops(iw) if iw <= 32 else _LimbOps(iw)


def _wrap_w(v, w: int):
    s = 32 - w
    return (v << s) >> s if s else v


def _phase_front(phase, pw: int):
    if pw > 31:
        # pw == 32 would need logical (unsigned) shifts on the quadrant
        # extraction; the practical int32-lane ceiling is 2^31 points
        raise ValueError("int32-lane CORDIC supports phase_width <= 31")
    un = jnp.asarray(phase, jnp.int32) & ((1 << pw) - 1)
    return un, un >> (pw - 2)


def _signed_phase(un, pw: int):
    """sphi = un - 2^pw for the upper half-period, else un — written so the
    2^pw constant never overflows the int32 weak type at pw == 31."""
    return jnp.where((un >> (pw - 1)) != 0, un + jnp.int32(-(1 << pw)), un)


# ---------------------------------------------------------------------------
# Pre-rotated flavors: cordic_dds48 / cordic_dds_scaled
# ---------------------------------------------------------------------------


def _cordic_prerotated_i32(phase, pw: int, w: int, size: int, dwph: int,
                           gain: int, lut_vals):
    """Shared input-side-pre-rotation engine (src/cordic_dds48.vhd:172-250,
    src/cordic_dds_scaled.vhd:186-275) on int32 lanes.  x/y at `size` bits,
    z at `dwph` bits; steering: z >= 0 => x += y>>i (z_pos_adds_to_x)."""
    xo, zo = _lane(size), _lane(dwph)
    un, q = _phase_front(phase, pw)
    low = un & ((1 << (pw - 2)) - 1)
    sphi = _signed_phase(un, pw)
    q03 = (q == 0) | (q == 3)
    init_t = jnp.where(q03, sphi,
                       jnp.where(q == 1, low, low - (1 << (pw - 2))))

    if size >= pw:
        z = zo.shl_wrap(zo.lift(init_t), size - pw)
    else:
        z = zo.wrap(zo.lift(init_t))  # vhd:190-192

    g = xo.const(gain)
    ng = xo.const(-gain)
    zero = xo.splat(xo.const(0), un.shape)
    x = xo.where(q03, xo.splat(g, un.shape), zero)
    y = xo.where(q == 1, xo.splat(ng, un.shape),
                 xo.where(q == 2, xo.splat(g, un.shape), zero))

    luts = [zo.const(v) for v in lut_vals]
    for i in range(w):
        neg = zo.is_neg(z)
        ys, xs = xo.shr(y, i), xo.shr(x, i)
        xn = xo.where(neg, xo.sub(x, ys), xo.add(x, ys))
        yn = xo.where(neg, xo.add(y, xs), xo.sub(y, xs))
        x, y = xo.wrap(xn), xo.wrap(yn)
        if i < w - 1:
            lk = zo.splat(luts[i], un.shape)
            z = zo.wrap(zo.where(neg, zo.add(z, lk), zo.sub(z, lk)))

    c = _wrap_w(xo.shr_to_i32(x, size - w), w)
    s = _wrap_w(xo.shr_to_i32(y, size - w), w)
    return c, s


def cordic_dds48_i32(phase, pw: int, w: int):
    """Bit-exact ``src/cordic_dds48.vhd`` on int32 lanes: 48-bit x/y/z state
    as radix-2^24 limb pairs, input-side quadrant pre-rotation, W x/y
    iterations, output = top W bits (vhd:257-258).  Preserves the reference's
    axis quirk: DT_SIN carries -sin (see kernels/cordic.py:cordic_dds48)."""
    if w > 32:
        raise ValueError("int32-lane output supports data_width <= 32")
    return _cordic_prerotated_i32(
        phase, pw, w, 48, 48, GAIN48_QUARTER, LUT_ATAN_2PI[: w - 1]
    )


def cordic_scaled_i32(phase, pw: int, w: int):
    """Bit-exact ``src/cordic_dds_scaled.vhd`` on int32 lanes: x/y at
    SEL_SIZE(w) bits, z at max(SIZE, PHASE_WIDTH) bits (vhd:100-143), limb
    pairs wherever a width exceeds 32."""
    size = scaled_internal_width(w)
    dwph = max(size, pw)
    gain = GAIN48_QUARTER >> (48 - size)
    luts = [LUT_ATAN_2PI[i] >> (48 - dwph) for i in range(w - 1)]
    return _cordic_prerotated_i32(phase, pw, w, size, dwph, gain, luts)


# ---------------------------------------------------------------------------
# Output-side flavors: cordic_dds (VHDL) / cordic_hls at wide data widths
# ---------------------------------------------------------------------------


def _quadrant_fix_out_i32(q, dat_c, dat_s, w: int):
    """Output-side quadrant correction on w-bit int32 values
    (src/cordic_dds.vhd:225-249)."""
    nc, ns = _wrap_w(-dat_c, w), _wrap_w(-dat_s, w)
    c = jnp.where(q == 0, dat_c, jnp.where(q == 1, ns, jnp.where(q == 2, nc, dat_s)))
    s = jnp.where(q == 0, dat_s, jnp.where(q == 1, dat_c, jnp.where(q == 2, ns, nc)))
    return c, s


def _cos_sin_dds_r2s(phase, pw: int, w: int, p: int):
    """Radix-2^s fast path of the dds flavor for internal width
    w + p in {33, 34} — the RTL window cores' production regime (W=32,
    PRECISION 1-2).  Same trick as window_kernel._cos_wide4: with
    s = iw - 32, state v = h*2^s + l where h is a *native int32* whose
    wraparound IS the iw-bit register wrap (h spans bits s..iw-1 = 32 bits)
    and l in [0, 2^s).  Steering multiplies by d = +-1; z needs no limbs:

    - |z| < 2^(iw-2) always (|z0| < 2^(iw-2) since init_t < 2^(pw-2),
      src/cordic_dds.vhd:179; lut[0] = 2^(iw-3) and |z'| <= max(|z|, lut)).
      For iw=33 that is < 2^31: plain int32 everywhere.  For iw=34, z0 >= 0
      (init_t is masked non-negative) so iteration 0's update is the static
      z1 = z0 - lut[0] in [-2^31, 2^31): computed on z0>>2 (init_z's low 2
      bits are provably 0 — both init shifts are >= p >= 2) then rescaled,
      exactly the _cos_wide4 z-fold.
    - iteration 0 is fully static: z0 >= 0 means x1 = gain, y1 = +gain
      (y0 = 0), so the loop starts at i = 1.

    Bit-exact vs cordic_dds_i32 / the golden model (full-period tests).
    ~2x fewer int32 ops per iteration than the radix-2^24 limb path.
    """
    iw = w + p
    s = iw - 32
    if s not in (1, 2):
        raise ValueError("radix-2^s dds path requires w + p in {33, 34}")
    if pw > 31:
        raise ValueError("int32-lane CORDIC supports phase_width <= 31")
    ms = (1 << s) - 1
    luts = [LUT_ATAN_PI[i] >> (49 - w - p) for i in range(w - 1)]
    gain = GAIN48_HALF >> (49 - w - p)

    un = jnp.asarray(phase, jnp.int32) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    init_t = un & ((1 << (pw - 2)) - 1)  # non-negative, vhd:179
    # init_z's value, carried >> s (fits int32: < 2^(iw-2-s) <= 2^30)
    if pw >= w:
        zh0 = (init_t >> (pw - w)) << (p - s)
    else:
        zh0 = init_t << (w - pw + p - s)

    # iteration 0 (z0 >= 0): x1 = gain, y1 = gain, z1 = z0 - lut[0]
    gh, gl = gain >> s, gain & ms
    xh = jnp.full(un.shape, gh, jnp.int32)
    xl = jnp.full(un.shape, gl, jnp.int32)
    yh, yl = xh, xl
    z = (zh0 - (luts[0] >> s)) << s  # exact: lut[0] = 2^(iw-3), low s bits 0

    for i in range(1, w - 1):
        d = (z >> 31) | 1
        if i < s:  # only i=1, s=2
            ysh, ysl = yh >> 1, ((yh & 1) << 1) | (yl >> 1)
            xsh, xsl = xh >> 1, ((xh & 1) << 1) | (xl >> 1)
        else:
            ysh, ysl = yh >> i, (yh >> (i - s)) & ms
            xsh, xsl = xh >> i, (xh >> (i - s)) & ms
        t1 = xl - d * ysl
        xh, xl = xh - d * ysh + (t1 >> s), t1 & ms
        t2 = yl + d * xsl
        yh, yl = yh + d * xsh + (t2 >> s), t2 & ms
        z = z - d * luts[i]

    # dat = wrap(v >> p, w): v >> p == h >> (p - s) exactly (l < 2^s <= 2^p)
    dat_c = _wrap_w(xh >> (p - s), w)
    dat_s = _wrap_w(yh >> (p - s), w)
    return _quadrant_fix_out_i32(q, dat_c, dat_s, w)


def cordic_dds_i32(phase, pw: int, w: int, p: int = 1):
    """Bit-exact ``src/cordic_dds.vhd`` on int32 lanes (W+P-bit state as limb
    pairs when W+P > 32): PRECISION guard bits, W-1 iterations, output-side
    quadrant fix.  This is the RTL window cores' sine source
    (src/bh_win_3term.vhd:185-201).  Internal widths 33/34 take the radix-2^s
    fast path (:func:`_cos_sin_dds_r2s`)."""
    if w > 32:
        raise ValueError("int32-lane output supports data_width <= 32")
    iw = w + p
    if iw in (33, 34):
        return _cos_sin_dds_r2s(phase, pw, w, p)
    o = _lane(iw)
    luts = [o.const(LUT_ATAN_PI[i] >> (49 - w - p)) for i in range(w - 1)]
    gain = o.const(GAIN48_HALF >> (49 - w - p))

    un, q = _phase_front(phase, pw)
    init_t = un & ((1 << (pw - 2)) - 1)  # "00" & low bits, vhd:179
    if pw >= w:
        z = o.shl_wrap(o.lift(init_t >> (pw - w)), p)
    else:
        z = o.shl_wrap(o.lift(init_t), w - pw + p)

    x = o.splat(gain, un.shape)
    y = o.splat(o.const(0), un.shape)
    for i in range(w - 1):
        neg = o.is_neg(z)
        ys, xs = o.shr(y, i), o.shr(x, i)
        xn = o.where(neg, o.add(x, ys), o.sub(x, ys))
        yn = o.where(neg, o.sub(y, xs), o.add(y, xs))
        x, y = o.wrap(xn), o.wrap(yn)
        lk = o.splat(luts[i], un.shape)
        z = o.wrap(o.where(neg, o.add(z, lk), o.sub(z, lk)))

    dat_c = _wrap_w(o.shr_to_i32(x, p), w)
    dat_s = _wrap_w(o.shr_to_i32(y, p), w)
    return _quadrant_fix_out_i32(q, dat_c, dat_s, w)


def cordic_cmodel_i32(phase, pw: int, w: int, p: int = 1):
    """Bit-exact plain-C-model flavor (cpp/cordic_sincos.cpp:10-92) on int32
    lanes.  The C model carries unwrapped ``long long`` state; its values
    never exceed |x|,|y| < 2^(w+1) and |z| < 2^(w+p) (gain seed 2^w/4·K,
    CORDIC growth sqrt(2)·K), so a (w+p+2)-bit lane reproduces the unwrapped
    arithmetic exactly — asserted vs the golden model in tests."""
    if w > 32:
        # The C model's own output stage casts to 32-bit int (cpp:89-90);
        # |x>>2| < 2^(w-1) so the int32 lane carries the outputs exactly.
        raise ValueError("int32-lane cmodel supports data_width <= 32")
    iw = w + p + 2
    o = _lane(iw)
    luts = [
        o.const((LUT_ATAN_2PI[i] >> (48 - w - p)) & 0xFFFFFFFFFFFF)
        for i in range(w - 1)
    ]
    gain = o.const(GAIN48_QUARTER >> (48 - w - 2))

    un, q = _phase_front(phase, pw)
    init_t = un & ~(0x3 << (pw - 2)) & ((1 << pw) - 1)
    if pw - 1 < w:
        z = o.shl_wrap(o.lift(init_t), w - pw + p)
    else:
        z = o.shl_wrap(o.lift(init_t >> (pw - w)), p)

    x = o.splat(gain, un.shape)
    y = o.splat(o.const(0), un.shape)
    for k in range(w):
        neg = o.is_neg(z)
        ys, xs = o.shr(y, k), o.shr(x, k)
        xn = o.where(neg, o.add(x, ys), o.sub(x, ys))
        yn = o.where(neg, o.sub(y, xs), o.add(y, xs))
        x, y = o.wrap(xn), o.wrap(yn)
        if k < w - 1:
            lk = o.splat(luts[k], un.shape)
            z = o.wrap(o.where(neg, o.add(z, lk), o.sub(z, lk)))

    out_c = o.shr_to_i32(x, 2)
    out_s = o.shr_to_i32(y, 2)
    nc, ns = ~out_c, ~out_s  # one's complement, cpp:75-85
    c = jnp.where(q == 0, out_c, jnp.where(q == 1, ns, jnp.where(q == 2, nc, out_s)))
    s = jnp.where(q == 0, out_s, jnp.where(q == 1, out_c, jnp.where(q == 2, ns, nc)))
    return c, s  # int cast (cpp:89-90) == the int32 lane itself


def cordic_atan2_core_i32(y, x, input_width: int, angle_width: int, p: int):
    """Vectoring-mode core (src/cordic_atan2.vhd:146-196) on int32 lanes,
    two-limb when angle_width + precision > 32.  Returns (quadrant, dat_phi)
    with dat_phi already wrapped to angle_width bits."""
    aw = angle_width
    iw = aw + p
    if input_width > 32:
        raise ValueError("int32-lane atan2 supports input_width <= 32")
    o = _lane(iw)
    luts = [o.const(LUT_ATAN_PI[i] >> (49 - aw - p)) for i in range(aw - 1)]

    x = jnp.asarray(x, jnp.int32)
    y = jnp.asarray(y, jnp.int32)
    sx = (x >> (input_width - 1)) & 1
    sy = (y >> (input_width - 1)) & 1
    quadrant = (sx << 1) | sy

    if aw > 32:
        raise ValueError("int32-lane atan2 supports angle_width <= 32")
    mask_lo = -1 if aw - 1 == 32 else (1 << (aw - 1)) - 1
    xx = o.lift((x ^ (-sx)) & mask_lo)  # one's-complement abs, low AW-1 bits
    yy = o.lift((y ^ (-sy)) & mask_lo)

    z = o.splat(o.const(0), x.shape)
    for i in range(aw - 1):
        pos = ~o.is_neg(yy)
        ys, xs = o.shr(yy, i), o.shr(xx, i)
        xn = o.where(pos, o.add(xx, ys), o.sub(xx, ys))
        yn = o.where(pos, o.sub(yy, xs), o.add(yy, xs))
        xx, yy = o.wrap(xn), o.wrap(yn)
        lk = o.splat(luts[i], x.shape)
        z = o.wrap(o.where(pos, o.sub(z, lk), o.add(z, lk)))

    return quadrant, _wrap_w(o.shr_to_i32(z, p), aw)


def cordic_hls_i32(phase, pw: int, w: int):
    """Bit-exact HLS-flavor CORDIC (hls/windows/win_function.cpp:47-156) on
    int32 lanes, both outputs.  The cosine-only fused variants live in
    ``window_kernel._cos_i32/_cos_wide/_cos_wide4``; this is the full (cos,
    sin) generator backing ``kernels.cordic.cordic_hls`` without x64 at W >= 31."""
    if w > 32:
        raise ValueError("int32-lane output supports data_width <= 32")
    iw = w + 2
    o = _lane(iw)
    luts = [o.const(v) for v in hls_atan_lut(w)]
    gain = o.const(GAIN48_QUARTER >> (46 - w))

    un, q = _phase_front(phase, pw)
    sphi = _signed_phase(un, pw)
    init_t = sphi & ~(0x3 << (pw - 2))
    if pw - 1 < w:
        z = o.shl_wrap(o.lift(init_t), w - pw + 2)
    else:
        z = o.shl_wrap(o.lift(init_t >> (pw - w)), 2)

    x = o.splat(gain, un.shape)
    y = o.splat(o.const(0), un.shape)
    for k in range(w):
        neg = o.is_neg(z)
        ys, xs = o.shr(y, k), o.shr(x, k)
        xn = o.where(neg, o.add(x, ys), o.sub(x, ys))
        yn = o.where(neg, o.sub(y, xs), o.add(y, xs))
        x, y = o.wrap(xn), o.wrap(yn)
        if k < w - 1:
            lk = o.splat(luts[k], un.shape)
            z = o.wrap(o.where(neg, o.add(z, lk), o.sub(z, lk)))

    # x>>2 fits iw-3 <= 31 bits, so the int32 carries it exactly; negation
    # mod 2^32 and negation mod 2^iw agree mod 2^w, so the final w-bit wrap
    # matches golden's wrap(~v + 1, iw) -> wrap(., w) ordering.
    out_c = o.shr_to_i32(x, 2)
    out_s = o.shr_to_i32(y, 2)
    nc, ns = -out_c, -out_s  # two's-complement negate (cpp:135-150)
    c = jnp.where(q == 0, out_c, jnp.where(q == 1, ns, jnp.where(q == 2, nc, out_s)))
    s = jnp.where(q == 0, out_s, jnp.where(q == 1, out_c, jnp.where(q == 2, ns, nc)))
    return _wrap_w(c, w), _wrap_w(s, w)
