"""Vectorized fixed-point CORDIC engines (jnp, dtype int32/int64 lanes).

Re-expression of the reference's rotation-mode CORDIC pipelines:
the reference unrolls the W iterations into *physical pipeline stages* at one
sample/clock (``src/cordic_dds.vhd:184-216``, ``hls/cordic/cordic.cpp:108-125``);
here the W iterations unroll into a *traced op sequence* while the sample axis
is the vectorized lane axis — pipeline-parallel-over-samples becomes
data-parallel-over-samples (SURVEY.md §2 "Parallelism & communication").

Five flavors, all bit-exact against ``model/golden.py`` (same reference
citations there).  Phases are taken mod 2^phase_width; any input shape.

These are the reference implementations the int32-lane datapaths
(``kernels/pallas/cordic_wide.py``) are verified against; they are
themselves jit-compatible and fully fused by XLA.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from ..core.config import CordicSpec
from ..core.fixedpoint import min_int_dtype
from ..core.luts import (
    GAIN48_HALF,
    GAIN48_QUARTER,
    LUT_ATAN_2PI,
    LUT_ATAN_PI,
    scaled_internal_width,
)


def _wrapper(iw: int, nbits: int):
    """Two's-complement wrap to iw bits inside an nbits carrier lane."""
    s = nbits - iw
    if s == 0:
        return lambda v: v
    return lambda v: (v << s) >> s


import jax as _jax


def _carrier(iw: int):
    # Promote narrow widths to int32: no narrower lane is faster.
    if iw <= 32:
        return jnp.int32
    dt = min_int_dtype(iw)
    if not _jax.config.read("jax_enable_x64"):
        raise ValueError(
            f"{iw}-bit CORDIC state needs int64 lanes; enable jax_enable_x64 "
            "or use the two-limb int32 datapaths (kernels.pallas)"
        )
    return dt


def _use_i32(internal_bits: int, pw: int, w: int) -> bool:
    """True when int64 lanes are unavailable (x64 off, the production regime) and the
    int32-lane two-limb path (kernels.pallas.cordic_wide) serves this config."""
    return (
        internal_bits > 32
        and not _jax.config.read("jax_enable_x64")
        and w <= 32
        and pw <= 31
    )


def _rotate(x, y, z, luts, n_xy, n_z, wrap_xy, wrap_z, z_pos_adds_to_x):
    """Shared unrolled iteration core.

    ``z_pos_adds_to_x``: sign convention.  False for the output-side flavors
    (hls/cmodel/dds: z<0 => x += y>>k) — True for the pre-rotated flavors
    (dds48/scaled: z>=0 => x += y>>k), src/cordic_dds48.vhd:234-242.
    """
    for k in range(n_xy):
        if z_pos_adds_to_x:
            neg = z < 0
        else:
            neg = z >= 0
        ys, xs = y >> k, x >> k
        x, y = (
            wrap_xy(jnp.where(neg, x - ys, x + ys)),
            wrap_xy(jnp.where(neg, y + xs, y - xs)),
        )
        if k < n_z:
            lk = luts[k]
            z = wrap_z(jnp.where(z < 0, z + lk, z - lk))
    return x, y, z


def _quadrant_fix_out(q, out_c, out_s, wrap_w):
    """Output-side quadrant correction (two's-complement negation):
    hls/windows/win_function.cpp:135-150 / src/cordic_dds.vhd:232-246."""
    nc, ns = -out_c, -out_s
    c = jnp.where(q == 0, out_c, jnp.where(q == 1, ns, jnp.where(q == 2, nc, out_s)))
    s = jnp.where(q == 0, out_s, jnp.where(q == 1, out_c, jnp.where(q == 2, ns, nc)))
    return wrap_w(c), wrap_w(s)


# ---------------------------------------------------------------------------


def cordic_sincos(phase, spec: CordicSpec):
    """Dispatch by flavor.  Returns ``(cos, sin)`` signed data_width-bit values
    in an int32/int64 carrier."""
    fn = {
        "hls": cordic_hls,
        "cmodel": cordic_cmodel,
        "dds": cordic_dds,
        "dds48": cordic_dds48,
        "scaled": cordic_scaled,
    }[spec.flavor]
    return fn(phase, spec)


def cordic_hls(phase, spec: CordicSpec):
    """HLS win_function flavor (hls/windows/win_function.cpp:47-156):
    W+2-bit wrapping state, 2^48/pi LUT, output-side quadrant fix.
    Amplitude ~2^(W-2)."""
    pw, w = spec.phase_width, spec.data_width
    iw = w + 2
    if _use_i32(max(iw, pw + 1), pw, w):
        from .pallas.cordic_wide import cordic_hls_i32

        return cordic_hls_i32(phase, pw, w)
    dt = _carrier(iw)
    nbits = jnp.iinfo(dt).bits
    wrap_iw = _wrapper(iw, nbits)
    wrap_w = _wrapper(w, nbits)

    from ..core.luts import hls_atan_lut

    # lut_angle[i] = (lut_table[i] >> (48-W-1)) & 0xFFFFFFFFFF into ap_int<W+2>
    # (win_function.cpp:78)
    luts = [jnp.asarray(v, dt) for v in hls_atan_lut(w)]
    gain = jnp.asarray(GAIN48_QUARTER >> (46 - w), dt)

    if pw + 1 > jnp.iinfo(dt).bits:
        dt_ph = _carrier(pw + 1)
    else:
        dt_ph = dt
    un = jnp.asarray(phase, dt_ph) & ((1 << pw) - 1)
    q = (un >> (pw - 2)).astype(dt)
    # init_t = signed(phi) & ~(3 << (pw-2)) at full phase width (see
    # model/golden.py cordic_hls for the ap_int<W+2> deviation note):
    # -2^pw as a dtype-safe constant: at pw == 31 on an int32 carrier the
    # Python literal 2^31 overflows argument parsing (the value -2^31 is
    # representable; the +2^31 intermediate is not)
    sphi = jnp.where(un >> (pw - 1) != 0,
                     un + jnp.asarray(-(1 << pw), un.dtype), un)
    init_t = sphi & ~(0x3 << (pw - 2))
    wrap_iw_ph = _wrapper(iw, jnp.iinfo(dt_ph).bits)
    if pw - 1 < w:
        init_z = wrap_iw_ph(init_t << (w - pw + 2)).astype(dt)
    else:
        init_z = wrap_iw_ph((init_t >> (pw - w)) << 2).astype(dt)

    x = jnp.full(un.shape, gain, dt)
    y = jnp.zeros(un.shape, dt)
    x, y, _ = _rotate(x, y, init_z, luts, w, w - 1, wrap_iw, wrap_iw, False)
    out_c, out_s = x >> 2, y >> 2
    return _quadrant_fix_out(q, out_c, out_s, wrap_w)


def cordic_cmodel(phase, spec: CordicSpec):
    """Plain C model flavor (cpp/cordic_sincos.cpp:10-92): int64 state (no
    wrap), 2^48/(2pi) LUT, one's-complement quadrant fix."""
    pw, w, p = spec.phase_width, spec.data_width, spec.precision
    if _use_i32(64, pw, w):
        from .pallas.cordic_wide import cordic_cmodel_i32

        return cordic_cmodel_i32(phase, pw, w, p)
    dt = _carrier(64)
    ident = lambda v: v

    lut = [(LUT_ATAN_2PI[i] >> (48 - w - p)) & 0xFFFFFFFFFFFF for i in range(w - 1)]
    luts = [jnp.asarray(v, dt) for v in lut]
    gain = jnp.asarray(GAIN48_QUARTER >> (48 - w - 2), dt)

    un = jnp.asarray(phase, dt) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    init_t = un & ~(0x3 << (pw - 2)) & ((1 << pw) - 1)
    if pw - 1 < w:
        init_z = init_t << (w - pw + p)
    else:
        init_z = (init_t >> (pw - w)) << p

    x = jnp.full_like(un, gain)
    y = jnp.zeros_like(un)
    x, y, _ = _rotate(x, y, init_z, luts, w, w - 1, ident, ident, False)
    out_c, out_s = x >> 2, y >> 2

    nc, ns = ~out_c, ~out_s  # one's complement, cpp:75-85
    c = jnp.where(q == 0, out_c, jnp.where(q == 1, ns, jnp.where(q == 2, nc, out_s)))
    s = jnp.where(q == 0, out_s, jnp.where(q == 1, out_c, jnp.where(q == 2, ns, nc)))
    w32 = _wrapper(32, 64)
    return w32(c).astype(jnp.int32), w32(s).astype(jnp.int32)


def cordic_dds(phase, spec: CordicSpec):
    """Main VHDL flavor (src/cordic_dds.vhd): W+P-bit state, PRECISION guard
    bits, W-1 iterations, output-side quadrant fix.  Amplitude ~2^(W-2)."""
    pw, w, p = spec.phase_width, spec.data_width, spec.precision
    iw = w + p
    if _use_i32(max(iw, pw + 1), pw, w):
        from .pallas.cordic_wide import cordic_dds_i32

        return cordic_dds_i32(phase, pw, w, p)
    dt = _carrier(iw)
    nbits = jnp.iinfo(dt).bits
    wrap_iw = _wrapper(iw, nbits)
    wrap_w = _wrapper(w, nbits)

    luts = [jnp.asarray(LUT_ATAN_PI[i] >> (49 - w - p), dt) for i in range(w - 1)]
    gain = jnp.asarray(GAIN48_HALF >> (49 - w - p), dt)

    un = jnp.asarray(phase, dt) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    init_t = un & ((1 << (pw - 2)) - 1)  # "00" & low bits (vhd:179)
    if pw >= w:
        init_z = (init_t >> (pw - w)) << p
    else:
        init_z = init_t << (w - pw + p)

    x = jnp.full_like(un, gain)
    y = jnp.zeros_like(un)
    x, y, _ = _rotate(x, y, init_z, luts, w - 1, w - 1, wrap_iw, wrap_iw, False)
    return _quadrant_fix_out(q, wrap_w(x >> p), wrap_w(y >> p), wrap_w)


def _prerotated_inputs(un, pw, gain, dt, wrap_xy):
    """Quadrant pre-rotation shared by dds48/scaled
    (src/cordic_dds48.vhd:172-216)."""
    q = un >> (pw - 2)
    low = un & ((1 << (pw - 2)) - 1)
    sphi = jnp.where(un >> (pw - 1) != 0,
                     un + jnp.asarray(-(1 << pw), un.dtype), un)
    init_t = jnp.where(
        (q == 0) | (q == 3), sphi, jnp.where(q == 1, low, low - (1 << (pw - 2)))
    )
    g = jnp.asarray(gain, dt)
    zero = jnp.zeros_like(un)
    x0 = jnp.where((q == 0) | (q == 3), g, zero)
    y0 = jnp.where(q == 1, wrap_xy(-g), jnp.where(q == 2, g, zero))
    return init_t, x0, y0


def cordic_dds48(phase, spec: CordicSpec):
    """Max-precision flavor (src/cordic_dds48.vhd): 48-bit x/y/z state,
    input-side pre-rotation, W x/y iterations, no output fix.

    Axis convention quirk of the reference: DT_COS is the true cosine;
    DT_SIN carries -sin (the window cores only consume DT_COS)."""
    pw, w = spec.phase_width, spec.data_width
    if _use_i32(48, pw, w):
        from .pallas.cordic_wide import cordic_dds48_i32

        return cordic_dds48_i32(phase, pw, w)
    iw = 48
    dt = _carrier(48)
    wrap_iw = _wrapper(iw, 64)
    wrap_w = _wrapper(w, 64)

    luts = [jnp.asarray(LUT_ATAN_2PI[i], dt) for i in range(w - 1)]

    un = jnp.asarray(phase, dt) & ((1 << pw) - 1)
    init_t, x0, y0 = _prerotated_inputs(un, pw, GAIN48_QUARTER, dt, wrap_iw)
    init_z = wrap_iw(init_t << (48 - pw))

    x, y, _ = _rotate(x0, y0, init_z, luts, w, w - 1, wrap_iw, wrap_iw, True)
    return wrap_w(x >> (48 - w)), wrap_w(y >> (48 - w))


def _atan2_core(y, x, input_width: int, angle_width: int, precision: int):
    """Shared vectoring-mode engine (src/cordic_atan2.vhd:146-196): returns
    (quadrant, dat_phi) where dat_phi ~ -atan(|y|/|x|) * 2^(AW-1)/pi."""
    aw, p = angle_width, precision
    iw_int = aw + p
    if (
        max(iw_int, input_width + 1) > 32
        and not _jax.config.read("jax_enable_x64")
        and aw <= 32
        and input_width <= 32
    ):
        from .pallas.cordic_wide import cordic_atan2_core_i32

        q, dat_phi = cordic_atan2_core_i32(y, x, input_width, aw, p)
        return q, dat_phi, _wrapper(aw, 32)
    dt = _carrier(max(iw_int, input_width + 1))
    nbits = jnp.iinfo(dt).bits
    wrap_iw = _wrapper(iw_int, nbits)
    wrap_aw = _wrapper(aw, nbits)

    luts = [jnp.asarray(LUT_ATAN_PI[i] >> (49 - aw - p), dt) for i in range(aw - 1)]

    x = jnp.asarray(x, dt)
    y = jnp.asarray(y, dt)
    sx = (x >> (input_width - 1)) & 1
    sy = (y >> (input_width - 1)) & 1
    quadrant = (sx << 1) | sy

    mask_lo = (1 << (aw - 1)) - 1
    xx = (x ^ (-sx)) & mask_lo  # one's-complement abs, low AW-1 bits
    yy = (y ^ (-sy)) & mask_lo

    z = jnp.zeros_like(xx)
    for i in range(aw - 1):
        pos = yy >= 0
        ys, xs = yy >> i, xx >> i
        xx, yy = (
            wrap_iw(jnp.where(pos, xx + ys, xx - ys)),
            wrap_iw(jnp.where(pos, yy - xs, yy + xs)),
        )
        z = wrap_iw(jnp.where(pos, z - luts[i], z + luts[i]))

    return quadrant, wrap_aw(z >> p), wrap_aw


def cordic_atan2(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Bit-exact vectorized ``src/cordic_atan2.vhd``.  Angle scale:
    pi == 2^(AW-1).

    Faithful to the reference's quadrant fix (vhd:204-219), whose output
    convention is NON-standard: Q1(x,y>0) -> -theta; Q2 -> pi-theta;
    Q3 -> pi/2-theta; Q4 -> theta-3pi/2.  Use :func:`atan2_fixed` for the
    standard atan2(y, x) convention with the same datapath.
    """
    q, dat_phi, wrap_aw = _atan2_core(y, x, input_width, angle_width, precision)
    phi_pi = 1 << (angle_width - 2)
    out = jnp.where(
        q == 0,
        dat_phi,
        jnp.where(
            q == 1,
            dat_phi + phi_pi,
            jnp.where(q == 2, -dat_phi, dat_phi - phi_pi),
        ),
    )
    return wrap_aw(out)


def atan2_fixed(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Standard-convention atan2(y, x) on the reference datapath: returns
    the angle in (-pi, pi], scaled pi == 2^(AW-1).  Same iteration core as
    :func:`cordic_atan2`; only the quadrant reconstruction differs."""
    q, dat_phi, wrap_aw = _atan2_core(y, x, input_width, angle_width, precision)
    base = -dat_phi  # +atan(|y|/|x|)
    pi_u = 1 << (angle_width - 1)
    out = jnp.where(
        q == 0,
        base,
        jnp.where(
            q == 1,
            -base,
            jnp.where(q == 2, pi_u - base, base - pi_u),
        ),
    )
    return wrap_aw(out)


def cordic_scaled(phase, spec: CordicSpec):
    """Empirical-width flavor (src/cordic_dds_scaled.vhd): x/y width from
    SEL_SIZE, z width max(SIZE, PW), input-side pre-rotation."""
    pw, w = spec.phase_width, spec.data_width
    size = scaled_internal_width(w)
    dwph = max(size, pw)
    if _use_i32(max(size, dwph, pw + 1), pw, w):
        from .pallas.cordic_wide import cordic_scaled_i32

        return cordic_scaled_i32(phase, pw, w)
    dt = _carrier(max(size, dwph, pw + 1))
    nbits = jnp.iinfo(dt).bits
    wrap_xy = _wrapper(size, nbits)
    wrap_z = _wrapper(dwph, nbits)
    wrap_w = _wrapper(w, nbits)

    luts = [jnp.asarray(LUT_ATAN_2PI[i] >> (48 - dwph), dt) for i in range(w - 1)]
    gain = GAIN48_QUARTER >> (48 - size)

    un = jnp.asarray(phase, dt) & ((1 << pw) - 1)
    init_t, x0, y0 = _prerotated_inputs(un, pw, gain, dt, wrap_xy)
    if size >= pw:
        init_z = wrap_z(init_t << (size - pw))
    else:
        init_z = wrap_z(init_t)

    x, y, _ = _rotate(x0, y0, init_z, luts, w, w - 1, wrap_xy, wrap_z, True)
    return wrap_w(x >> (size - w)), wrap_w(y >> (size - w))
