"""Exact scalar golden models (pure Python ints, arbitrary precision).

These are the bit-exact functional specifications of every fixed-point engine
in the framework, transcribed from the reference's three parallel
implementations (VHDL / HLS-C++ / plain C++) of hukenovs/blackman_harris_win.
Every vectorized jnp kernel in ``kernels/`` is tested for 0-LSB
equality against these models.

Flavor map (reference file -> model function):

- ``hls/windows/win_function.cpp:47-156``  -> :func:`cordic_hls`
  (W+2-bit wrapping internal state, output-side quadrant fix, LUT scale
  2^48/pi).  This is the flavor the window functions are specified against.
- ``cpp/cordic_sincos.cpp:10-92``          -> :func:`cordic_cmodel`
  (64-bit internal state, one's-complement quadrant fix, LUT scale 2^48/2pi).
- ``src/cordic_dds.vhd``                   -> :func:`cordic_dds`
  (W+P-bit state, PRECISION guard bits, output-side quadrant fix,
  W-1 iterations).
- ``src/cordic_dds48.vhd``                 -> :func:`cordic_dds48`
  (48-bit state, input-side quadrant pre-rotation, W iterations).
- ``src/cordic_dds_scaled.vhd``            -> :func:`cordic_scaled`
  (SEL_SIZE internal width, input-side pre-rotation).
- ``hls/windows/win_function.cpp:168-422`` -> :func:`win_function`
  (runtime-dispatch cosine-sum windows, HLS rounding).
- ``src/{hamming_win,bh_win_*}.vhd``       -> :func:`win_rtl`
  (VHDL rounding contract: product slice [2W-2:W-2], round-half-up off
  bit 0, W+2-bit adder tree, final round off bit 1).

All phase arguments are taken as non-negative ints and reduced mod 2^PW; the
models handle the signed reinterpretation internally exactly as ap_int /
std_logic_signed would.
"""

from __future__ import annotations

from ..core.luts import (
    GAIN48_HALF,
    GAIN48_QUARTER,
    LUT_ATAN_2PI,
    LUT_ATAN_PI,
    scaled_internal_width,
)
from ..core.fixedpoint import (
    round_half_up_bit0,
    round_half_up_bit1,
    wrap,
)


def _as_signed_phase(n: int, phase_width: int) -> int:
    """Reduce mod 2^PW and reinterpret as signed PW-bit (ap_int<PW>)."""
    return wrap(n & ((1 << phase_width) - 1), phase_width)


# ---------------------------------------------------------------------------
# Flavor 1: HLS win_function CORDIC (the window spec flavor)
# ---------------------------------------------------------------------------

def cordic_hls(n: int, phase_width: int, data_width: int) -> tuple[int, int]:
    """Bit-exact model of the CORDIC in ``hls/windows/win_function.cpp:47-156``.

    Returns ``(cos, sin)`` as signed ``data_width``-bit ints with amplitude
    ~2^(data_width-2).  Internal state is ``data_width+2``-bit wrapping
    (ap_int<NWIDTH+2>).
    """
    pw, w = phase_width, data_width
    iw = w + 2  # dat_t = ap_int<NWIDTH+2>, win_function.h:61

    # lut_angle[i] = lut_table[i] >> (48 - NWIDTH - 2 + 1), win_function.cpp:78
    lut = [wrap((LUT_ATAN_PI[i] >> (47 - w)) & 0xFFFFFFFFFF, iw) for i in range(w - 1)]
    gain = GAIN48_QUARTER >> (46 - w)  # win_function.cpp:83

    sphi = _as_signed_phase(n, pw)
    quadrant = (n & ((1 << pw) - 1)) >> (pw - 2)  # duo_t cast, cpp:86

    # init_t = phi & ~(0x3 << (NPHASE-2)), win_function.cpp:88.  The reference
    # stores it in dat_t = ap_int<W+2>, which silently destroys phase bits
    # when NPHASE > NWIDTH+3 (a regime the reference never exercises; its
    # configs have NPHASE < NWIDTH).  We keep init_t at full phase width —
    # bit-identical to the reference whenever NPHASE <= NWIDTH+3, and the
    # natural phase-decimation generalization (matching src/cordic_dds.vhd's
    # correct wide-phase handling) beyond it.
    init_t = sphi & ~(0x3 << (pw - 2))
    if pw - 1 < w:
        init_z = wrap(init_t << (w - pw + 2), iw)  # cpp:92
    else:
        init_z = wrap((init_t >> (pw - w)) << 2, iw)  # cpp:95

    x, y, z = gain, 0, init_z
    for k in range(w):
        if z < 0:
            x, y = wrap(x + (y >> k), iw), wrap(y - (x >> k), iw)
        else:
            x, y = wrap(x - (y >> k), iw), wrap(y + (x >> k), iw)
        # Last z update reads past the LUT in the reference (harmless: z[W]
        # is never consumed) — skip it.  cpp:110-125
        if k < w - 1:
            z = wrap(z + lut[k] if z < 0 else z - lut[k], iw)

    out_c, out_s = x >> 2, y >> 2  # cpp:128-129

    if quadrant == 0:
        dat_c, dat_s = out_c, out_s
    elif quadrant == 1:
        dat_c, dat_s = wrap(~out_s + 1, iw), out_c
    elif quadrant == 2:
        dat_c, dat_s = wrap(~out_c + 1, iw), wrap(~out_s + 1, iw)
    else:
        dat_c, dat_s = out_s, wrap(~out_c + 1, iw)

    return wrap(dat_c, w), wrap(dat_s, w)  # win_t cast


# ---------------------------------------------------------------------------
# Flavor 2: plain C model (cpp/cordic_sincos.cpp)
# ---------------------------------------------------------------------------

def cordic_cmodel(
    n: int, phase_width: int, data_width: int, precision: int = 1
) -> tuple[int, int]:
    """Bit-exact model of ``cpp/cordic_sincos.cpp:10-92`` (64-bit long long
    state, no register wrap, one's-complement quadrant negation, 2pi LUT)."""
    pw, w = phase_width, data_width

    lut = [
        (LUT_ATAN_2PI[i] >> (48 - w - precision)) & 0xFFFFFFFFFFFF
        for i in range(w - 1)
    ]
    gain = GAIN48_QUARTER >> (48 - w - 2)  # cordic_sincos.cpp:21-22

    theta = n & ((1 << pw) - 1)
    quadrant = theta >> (pw - 2)  # cpp:25 (theta non-negative in main loop)
    init_t = theta & ~(0x3 << (pw - 2))
    if pw - 1 < w:
        init_z = init_t << (w - pw + precision)  # cpp:32
    else:
        init_z = (init_t >> (pw - w)) << precision  # cpp:35

    x, y, z = gain, 0, init_z
    for k in range(w):
        if z < 0:
            x, y = x + (y >> k), y - (x >> k)
        else:
            x, y = x - (y >> k), y + (x >> k)
        if k < w - 1:  # cpp:58-62 (last entry OOB in ref; z[W] unused)
            z = z + lut[k] if z < 0 else z - lut[k]

    out_c, out_s = x >> 2, y >> 2

    if quadrant == 0:
        dat_c, dat_s = out_c, out_s
    elif quadrant == 1:
        dat_c, dat_s = ~out_s, out_c  # one's complement, cpp:75-78
    elif quadrant == 2:
        dat_c, dat_s = ~out_c, ~out_s
    else:
        dat_c, dat_s = out_s, ~out_c

    return wrap(dat_c, 32), wrap(dat_s, 32)  # int cast, cpp:89-90


# ---------------------------------------------------------------------------
# Flavor 3: cordic_dds (VHDL main flavor used inside the window cores)
# ---------------------------------------------------------------------------

def cordic_dds(
    n: int, phase_width: int, data_width: int, precision: int = 1
) -> tuple[int, int]:
    """Bit-exact model of ``src/cordic_dds.vhd`` (W+P-bit state, output-side
    quadrant fix, W-1 x/y iterations).  Returns ``(cos, sin)``, amplitude
    ~2^(data_width-1)/K' (the half-scale gain seed, cordic_dds.vhd:97-98)."""
    pw, w, p = phase_width, data_width, precision
    iw = w + p

    # ROM_TABLE: top (W+P-1) bits of ROM_LUT entry, zero MSB (vhd:121-129)
    lut = [LUT_ATAN_PI[i] >> (49 - w - p) for i in range(w - 1)]
    gain = GAIN48_HALF >> (49 - w - p)  # "0" & GAIN48(47 downto 48-W-P+1), vhd:98

    un = n & ((1 << pw) - 1)
    quadrant = un >> (pw - 2)  # delayed MSBs, vhd:170-172
    init_t = un & ((1 << (pw - 2)) - 1)  # "00" & ph_in(left-2:0), vhd:179
    if pw >= w:
        init_z = (init_t >> (pw - w)) << p  # vhd:159-162
    else:
        init_z = init_t << (w - pw + p)  # vhd:163-166

    x, y, z = gain, 0, init_z
    for i in range(w - 1):  # lpXY/lpZ: 0..DATA_WIDTH-2, vhd:197-213
        if z < 0:  # sign bit '1'
            x, y = wrap(x + (y >> i), iw), wrap(y - (x >> i), iw)
        else:
            x, y = wrap(x - (y >> i), iw), wrap(y + (x >> i), iw)
        z = wrap(z + lut[i] if z < 0 else z - lut[i], iw)

    dat_c = wrap(x >> p, w)  # sigX(W-1)(W+P-1 downto P), vhd:218-219
    dat_s = wrap(y >> p, w)

    if quadrant == 0:
        c, s = dat_c, dat_s
    elif quadrant == 1:
        c, s = wrap(-dat_s, w), dat_c
    elif quadrant == 2:
        c, s = wrap(-dat_c, w), wrap(-dat_s, w)
    else:
        c, s = dat_s, wrap(-dat_c, w)

    return c, s


# ---------------------------------------------------------------------------
# Flavor 4: cordic_dds48 (48-bit state, input-side pre-rotation)
# ---------------------------------------------------------------------------

def cordic_dds48(n: int, phase_width: int, data_width: int) -> tuple[int, int]:
    """Bit-exact model of ``src/cordic_dds48.vhd`` (fixed 48-bit x/y/z state,
    quadrant handled by pre-rotating the start vector, no output fix).

    Note the reference's X/Y axis convention here differs from the other
    flavors (header comment "X represents the sine"): DT_COS carries the true
    cosine; DT_SIN carries -sin.  The window cores only consume DT_COS
    (src/bh_win_3term.vhd:185-201), so this asymmetry is part of the contract.
    """
    pw, w = phase_width, data_width
    iw = 48

    lut = list(LUT_ATAN_2PI[: w - 1])
    gain = GAIN48_QUARTER

    un = n & ((1 << pw) - 1)
    quadrant = un >> (pw - 2)
    low = un & ((1 << (pw - 2)) - 1)

    # pr_phi quadrant pre-rotation (vhd:172-188)
    if quadrant in (0, 3):
        init_t = _as_signed_phase(un, pw)
    elif quadrant == 1:
        init_t = low  # "00" & low
    else:  # quadrant == 2
        init_t = low - (1 << (pw - 2))  # "11" & low

    init_z = wrap(init_t << (48 - pw), iw)  # left-aligned, vhd:164-165

    # pr_xy start vector per quadrant (vhd:193-216)
    if quadrant in (0, 3):
        x, y = gain, 0
    elif quadrant == 1:
        x, y = 0, wrap(~gain + 1, iw)
    else:
        x, y = 0, gain

    z = init_z
    for i in range(w):  # xl: 0..DATA_WIDTH-1, vhd:234-242
        if z >= 0:  # sign bit '0'
            x, y = wrap(x + (y >> i), iw), wrap(y - (x >> i), iw)
        else:
            x, y = wrap(x - (y >> i), iw), wrap(y + (x >> i), iw)
        if i < w - 1:  # xp: 0..DATA_WIDTH-2, vhd:244-250
            z = wrap(z + lut[i] if z < 0 else z - lut[i], iw)

    cos_out = wrap(x >> (48 - w), w)  # top W bits, vhd:257-258
    sin_out = wrap(y >> (48 - w), w)
    return cos_out, sin_out


# ---------------------------------------------------------------------------
# Flavor 5: cordic_dds_scaled (SEL_SIZE internal width)
# ---------------------------------------------------------------------------

def cordic_scaled(n: int, phase_width: int, data_width: int) -> tuple[int, int]:
    """Bit-exact model of ``src/cordic_dds_scaled.vhd`` (internal x/y width
    from the empirical SEL_SIZE table, z width max(SIZE, PHASE_WIDTH),
    input-side pre-rotation like dds48)."""
    pw, w = phase_width, data_width
    size = scaled_internal_width(w)
    dwph = max(size, pw)  # vhd:132-143

    lut = [LUT_ATAN_2PI[i] >> (48 - dwph) for i in range(w - 1)]  # vhd:149-156
    gain = GAIN48_QUARTER >> (48 - size)  # vhd:111

    un = n & ((1 << pw) - 1)
    quadrant = un >> (pw - 2)
    low = un & ((1 << (pw - 2)) - 1)

    if quadrant in (0, 3):
        init_t = _as_signed_phase(un, pw)
    elif quadrant == 1:
        init_t = low
    else:
        init_t = low - (1 << (pw - 2))

    if size >= pw:
        init_z = wrap(init_t << (size - pw), dwph)  # vhd:186-189
    else:
        init_z = wrap(init_t, dwph)  # vhd:190-192

    if quadrant in (0, 3):
        x, y = gain, 0
    elif quadrant == 1:
        x, y = 0, wrap(~gain + 1, size)
    else:
        x, y = 0, gain

    z = init_z
    for i in range(w):  # xl: 0..DATA_WIDTH-1, vhd:259-267
        if z >= 0:
            x, y = wrap(x + (y >> i), size), wrap(y - (x >> i), size)
        else:
            x, y = wrap(x - (y >> i), size), wrap(y + (x >> i), size)
        if i < w - 1:  # xp loop, vhd:269-275
            z = wrap(z + lut[i] if z < 0 else z - lut[i], dwph)

    cos_out = wrap(x >> (size - w), w)  # top W bits, vhd:282-283
    sin_out = wrap(y >> (size - w), w)
    return cos_out, sin_out


# ---------------------------------------------------------------------------
# Vectoring mode: cordic_atan2 (src/cordic_atan2.vhd)
# ---------------------------------------------------------------------------

def cordic_atan2(
    y: int,
    x: int,
    input_width: int,
    angle_width: int,
    precision: int = 1,
) -> int:
    """Bit-exact model of ``src/cordic_atan2.vhd`` (vectoring mode).

    Returns the signed ``angle_width``-bit angle word; scale: pi == 2^(AW-1)
    (PHI_PI = 2^(AW-2) is pi/2, vhd:116).

    Faithful quirks of the reference:
    - |x|,|y| via XOR-with-sign (one's-complement abs, vhd:146-156) and only
      the low ANGLE_WIDTH-1 bits of the inputs enter the datapath;
    - z accumulates the *applied* rotation, so the magnitude before quadrant
      fix is -atan(|y|/|x|);
    - quadrant fix: q00 -> z, q01 -> z+pi/2, q10 -> -z, q11 -> z-pi/2
      (vhd:204-219).  Net convention (verified in tests):
      PHI_DT ~ -arg(x, y) * 2^(AW-1) / pi for x >= 0, with the half-pi
      offsets placing x<0 results in the outer quadrants.
    """
    aw, p = angle_width, precision
    iw_int = aw + p

    lut = [LUT_ATAN_PI[i] >> (49 - aw - p) for i in range(aw - 1)]

    sx = (x >> (input_width - 1)) & 1
    sy = (y >> (input_width - 1)) & 1
    quadrant = (sx << 1) | sy

    mask_lo = (1 << (aw - 1)) - 1
    ix = (x ^ (-sx)) & mask_lo  # bitwise xor with replicated sign bit
    iy = (y ^ (-sy)) & mask_lo

    xx, yy, z = ix, iy, 0
    for i in range(aw - 1):
        if yy >= 0:
            xx, yy = (
                wrap(xx + (yy >> i), iw_int),
                wrap(yy - (xx >> i), iw_int),
            )
            z = wrap(z - lut[i], iw_int)
        else:
            xx, yy = (
                wrap(xx - (yy >> i), iw_int),
                wrap(yy + (xx >> i), iw_int),
            )
            z = wrap(z + lut[i], iw_int)

    dat_phi = wrap(z >> p, aw)
    phi_pi = 1 << (aw - 2)

    if quadrant == 0:
        out = dat_phi
    elif quadrant == 1:
        out = dat_phi + phi_pi
    elif quadrant == 2:
        out = -dat_phi
    else:
        out = dat_phi - phi_pi
    return wrap(out, aw)


# ---------------------------------------------------------------------------
# Taylor fast path (src/taylor_sincos.vhd + src/tay1_order.vhd)
# ---------------------------------------------------------------------------

def taylor_rom_entry(ii: int, lut_size: int, data_width: int) -> tuple[int, int]:
    """Quarter-wave ROM entry ii: (cos, sin) = round((2^(W-1)-1) * cos/sin
    (ii*pi/(2*2^LUT_SIZE))) — src/taylor_sincos.vhd:91-109 (VHDL INTEGER()
    rounds to nearest; entries are non-negative)."""
    import math

    ang = ii * math.pi / (2.0 * (1 << lut_size))
    amp = 2.0 ** (data_width - 1) - 1.0
    return (int(math.floor(amp * math.cos(ang) + 0.5)),
            int(math.floor(amp * math.sin(ang) + 0.5)))


def tay1_correction(
    cos_v: int, sin_v: int, acnt: int, stage: int, val_shift: int, data_width: int
) -> tuple[int, int]:
    """1st-order Taylor correction (src/tay1_order.vhd):
    cos' = cos - (mpi*sin) >> XSHIFT, sin' = sin + (mpi*cos) >> XSHIFT,
    mpi = round(pi * 2^(17-STAGE)) * acnt, XSHIFT = 19 + VAL_SHIFT
    (tay1_order.vhd:112,130-147).

    Width-dependent arithmetic (faithful):
    - W < 19: 48-bit DSP accumulate (C +/- A*B) then slice
      [XSHIFT+W-1 : XSHIFT] (wrap, no saturation) — vhd:180-504;
    - W >= 19: product sliced to W bits first, W-bit add/sub (wrap), then
      negative results clamp to 2^(W-1)-1 ("scale overflow", vhd:601-617).
    """
    import math

    w = data_width
    xshift = 19 + val_shift
    mpi = int(math.floor(math.pi * 2.0 ** (17 - stage) + 0.5)) * acnt

    if w < 19:
        cos_p = (cos_v << xshift) - mpi * sin_v  # 48-bit DSP P register
        sin_p = (sin_v << xshift) + mpi * cos_v
        return wrap(cos_p >> xshift, w), wrap(sin_p >> xshift, w)

    bb_sin = wrap((mpi * sin_v) >> xshift, w)
    bb_cos = wrap((mpi * cos_v) >> xshift, w)
    cos_p = wrap(cos_v - bb_sin, w)
    sin_p = wrap(sin_v + bb_cos, w)
    clamp = (1 << (w - 1)) - 1
    return (clamp if cos_p < 0 else cos_p, clamp if sin_p < 0 else sin_p)


def taylor_sincos(
    n: int, phase_width: int, data_width: int, lut_size: int
) -> tuple[int, int]:
    """Bit-exact model of src/taylor_sincos.vhd: quarter-wave LUT plus
    optional 1st-order Taylor interpolation, output-side quadrant fix.
    Amplitude ~2^(W-1) (full scale, unlike the CORDIC flavors' 2^(W-2)).

    Three regimes on PW-LS (taylor_sincos.vhd:157-221):
      < 2 : LUT address = phase bits top-aligned (low zeros), pure LUT;
      = 2 : exact quarter-wave LUT, no interpolation;
      > 2 : LUT address = high bits, residual counter -> tay1 correction
            with STAGE = PW-LS-3, VAL_SHIFT = LS.
    """
    pw, w, ls = phase_width, data_width, lut_size
    cnt = n & ((1 << pw) - 1)
    quadrant = cnt >> (pw - 2)
    ph = cnt & ((1 << (pw - 2)) - 1)  # cnt(PW-3 downto 0)

    if pw - ls < 2:
        addr = ph << (ls - pw + 2)  # top-aligned (vhd:159-160)
        mem_cos, mem_sin = taylor_rom_entry(addr, ls, w)
    elif pw - ls == 2:
        addr = ph
        mem_cos, mem_sin = taylor_rom_entry(addr, ls, w)
    else:
        stage = pw - ls - 3
        addr = ph >> (pw - ls - 2)  # cnt(PW-3 downto PW-LS-2), vhd:190
        acnt = ph & ((1 << (pw - ls - 2)) - 1)  # vhd:191
        rc, rs = taylor_rom_entry(addr, ls, w)
        mem_cos, mem_sin = tay1_correction(rc, rs, acnt, stage, ls, w)

    if quadrant == 0:
        return mem_cos, mem_sin
    if quadrant == 1:
        return wrap(-mem_sin, w), mem_cos
    if quadrant == 2:
        return wrap(-mem_cos, w), wrap(-mem_sin, w)
    return mem_sin, wrap(-mem_cos, w)


# ---------------------------------------------------------------------------
# Windows — HLS semantics (hls/windows/win_function.cpp:158-422)
# ---------------------------------------------------------------------------

def win_cosine_sum_hls(
    n: int,
    coeffs_q: tuple[int, ...],
    phase_width: int,
    data_width: int,
) -> int:
    """Generic quantized cosine-sum window sample, HLS semantics:
    ``w[n] = a0 - m1 + m2 - m3 + ...`` with ``m_k = (a_k * cos(k n)) >> (W-2)``
    (``hls/windows/win_function.cpp:361-375``).  ``coeffs_q`` are the already
    quantized integer coefficients (a0..aK)."""
    pw, w = phase_width, data_width
    acc = coeffs_q[0]
    for k in range(1, len(coeffs_q)):
        c, _s = cordic_hls((k * n) & ((1 << pw) - 1), pw, w)
        m = (coeffs_q[k] * c) >> (w - 2)
        acc = acc - m if k % 2 == 1 else acc + m
    return wrap(acc, w)  # win_t cast


# ---------------------------------------------------------------------------
# Windows — RTL semantics (VHDL window cores)
# ---------------------------------------------------------------------------

def win_cosine_sum_rtl(
    n: int,
    coeffs_q: tuple[int, ...],
    phase_width: int,
    data_width: int,
    precision: int = 1,
) -> int:
    """Generic quantized cosine-sum window sample, VHDL rounding contract
    (src/bh_win_3term.vhd:257-306 and siblings):

    - cos_k from :func:`cordic_dds` (phase counters stepping +k ==
      closed-form (k*n) mod 2^PW);
    - full product ``a_k * cos_k`` (2W bits), slice ``[2W-2 : W-2]`` -> W+1
      bits; round-half-up off bit 0 -> W bits;
    - alternating-sign adder tree in W+2 bits;
    - final round-half-up off bit 1 -> W bits.

    The 2-term core (hamming_win.vhd) differs: W+1-bit subtract then final
    round off bit 0 — see :func:`win_2term_rtl`.
    """
    pw, w = phase_width, data_width
    nterms = len(coeffs_q)
    if nterms == 2:
        return win_2term_rtl(n, coeffs_q, pw, w, precision)

    bs = [coeffs_q[0]]
    for k in range(1, nterms):
        c, _s = cordic_dds((k * n) & ((1 << pw) - 1), pw, w, precision)
        p = coeffs_q[k] * c  # 2W-bit product
        r = wrap(p >> (w - 2), w + 1)  # mult_p(2W-2 downto W-2)
        bs.append(wrap(round_half_up_bit0(r), w))

    acc = 0
    for k, b in enumerate(bs):
        acc = acc + b if k % 2 == 0 else acc - b
    pp = wrap(acc, w + 2)
    return wrap(round_half_up_bit1(pp), w)


def win_2term_rtl(
    n: int,
    coeffs_q: tuple[int, ...],
    phase_width: int,
    data_width: int,
    precision: int = 1,
) -> int:
    """2-term (Hamming/Hann) VHDL core: src/hamming_win.vhd:183-231.
    Product slice keeps one guard bit, subtract from A0 in W+1 bits, final
    round off bit 0."""
    pw, w = phase_width, data_width
    a0, a1 = coeffs_q
    c, _s = cordic_dds(n & ((1 << pw) - 1), pw, w, precision)
    p = a1 * c
    r = wrap(p >> (w - 2), w + 1)
    b = wrap(round_half_up_bit0(r), w)
    pp = wrap(a0 - b, w + 1)
    return wrap(round_half_up_bit0(pp), w)
