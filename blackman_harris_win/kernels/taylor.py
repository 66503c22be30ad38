"""Vectorized quarter-wave-LUT + 1st-order-Taylor sine/cosine (the fast path).

Re-expression of ``src/taylor_sincos.vhd`` + ``src/tay1_order.vhd``: the
block-ROM becomes a device table driven by an XLA gather, and the two
DSP48 MACCs per sample become fused multiply-shift lanes.  Bit-exact against
``model/golden.py:taylor_sincos`` (same reference citations there).

Amplitude is ~2^(W-1) — full scale, twice the CORDIC flavors — matching the
reference (ROM entries scale (2^(W-1)-1), taylor_sincos.vhd:101-102).

The per-width arithmetic split is faithful: W<19 accumulates in the wide
(48-bit DSP P) domain then slices; W>=19 slices the product first, adds in W
bits, and clamps negative results to +max ("scale overflow",
tay1_order.vhd:601-617).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=32)
def _rom(lut_size: int, data_width: int):
    """Quarter-wave ROM: (2^LS, 2) array of (cos, sin) entries
    (src/taylor_sincos.vhd:91-109)."""
    n = 1 << lut_size
    ii = np.arange(n)
    ang = ii * math.pi / (2.0 * n)
    amp = 2.0 ** (data_width - 1) - 1.0
    cos_e = np.floor(amp * np.cos(ang) + 0.5).astype(np.int64)
    sin_e = np.floor(amp * np.sin(ang) + 0.5).astype(np.int64)
    dt = np.int32 if data_width <= 32 else np.int64
    return np.stack([cos_e, sin_e], axis=-1).astype(dt)


def taylor_sincos(n, phase_width: int, data_width: int, lut_size: int):
    """(cos, sin) at sample indices ``n`` (any shape; reduced mod 2^PW)."""
    pw, w, ls = phase_width, data_width, lut_size
    if ls >= pw:
        raise ValueError("LUT_SIZE must be < PHASE_WIDTH (src/win_selector.vhd:68)")
    if w > 32:
        # the int32-lane datapath would silently truncate the ROM values;
        # fail loudly instead (project rule: guarded or lane-clean).  The
        # reference's DSP48 MACC datapaths top out at 32-bit outputs too.
        raise ValueError("taylor_sincos supports data_width <= 32")

    rom = jnp.asarray(_rom(ls, w))
    dt = rom.dtype

    cnt = jnp.asarray(n, jnp.int32) & ((1 << pw) - 1)
    quadrant = cnt >> (pw - 2)
    ph = cnt & ((1 << (pw - 2)) - 1)

    if pw - ls < 2:
        addr = ph << (ls - pw + 2)
        ent = rom[addr]
        mem_cos, mem_sin = ent[..., 0], ent[..., 1]
    elif pw - ls == 2:
        ent = rom[ph]
        mem_cos, mem_sin = ent[..., 0], ent[..., 1]
    else:
        stage = pw - ls - 3
        addr = ph >> (pw - ls - 2)
        acnt = ph & ((1 << (pw - ls - 2)) - 1)
        ent = rom[addr]
        mem_cos, mem_sin = _tay1(
            ent[..., 0], ent[..., 1], acnt, stage, ls, w
        )

    nbits = jnp.iinfo(dt).bits
    sw = nbits - w
    wrap_w = (lambda v: (v << sw) >> sw) if sw else (lambda v: v)
    nc, ns = wrap_w(-mem_cos.astype(dt)), wrap_w(-mem_sin.astype(dt))
    c = jnp.where(
        quadrant == 0,
        mem_cos,
        jnp.where(quadrant == 1, ns, jnp.where(quadrant == 2, nc, mem_sin)),
    )
    s = jnp.where(
        quadrant == 0,
        mem_sin,
        jnp.where(quadrant == 1, mem_cos, jnp.where(quadrant == 2, ns, nc)),
    )
    return c, s


def taylor_sincos_block(n0, count: int, phase_width: int, data_width: int,
                        lut_size: int):
    """Gather-free (cos, sin) over the consecutive index block
    [n0, n0 + count) — bit-exact vs :func:`taylor_sincos`.

    The indexed form's ``rom[addr]`` gather is XLA-gather-bound at bulk
    sizes (measured 295 Msamp/s at 64M — *below* the reference FPGA's
    400).  For consecutive samples the structure removes the gather: with
    R = 2^(PW-LS-2) residuals per LUT step, every R-aligned run shares one
    ROM entry, so the block lays out as (rows, R) where

      - the row's ROM entries are CONSECUTIVE addresses -> one
        ``dynamic_slice`` of a doubled ROM (circular wrap), no gather;
      - the residual counter acnt == the column index -> the pi*acnt
        correction operand is a single (1, R) row computed once;
      - the quadrant is constant per row -> a (rows, 1) select.

    The tay1 correction then runs as rank-1 broadcasts (outer-product
    style, like ``outerwin.py``).  Constraints: ``n0`` must be R-aligned
    and ``count`` a multiple of R with count/R <= 2^LUT_SIZE rows per call
    (the pure-LUT regimes PW-LS <= 2 use R = 1 with strided ROM slicing).
    ``n0`` may be traced (R-alignment is asserted statically only when
    concrete).  Returns int32 arrays of shape (count,).
    """
    pw, w, ls = phase_width, data_width, lut_size
    if ls >= pw:
        raise ValueError("LUT_SIZE must be < PHASE_WIDTH (src/win_selector.vhd:68)")
    if w > 32:
        raise ValueError("taylor supports data_width <= 32")
    rsh = max(pw - ls - 2, 0)  # log2 residuals per ROM step
    r = 1 << rsh
    if count % r:
        raise ValueError(f"count {count} must be a multiple of R = {r}")
    rows = count // r
    # one circular ROM wrap max: rows bounded by the per-quadrant step
    # count (= 2^ls in the tay1/exact regimes, 2^(pw-2) when the LUT is
    # wider than the quarter phase)
    max_rows = min(1 << ls, 1 << (pw - 2))
    if rows > max_rows:
        raise ValueError(
            f"count/R = {rows} rows exceed {max_rows} (split the block)"
        )
    if isinstance(n0, int) and n0 % r:
        raise ValueError(f"n0 {n0} must be R-aligned (R = {r})")

    rom = jnp.asarray(_rom(ls, w))  # (2^ls, 2) int32
    n0 = jnp.asarray(n0, jnp.int32)

    # per-row step index t_i = (n0/R + i) mod 2^(pw-rsh): quadrant = top 2
    # bits, LUT position = the ls (or pw-2) low bits
    steps_mask = (1 << (pw - rsh)) - 1
    t0 = (n0 >> rsh) & steps_mask
    ti = (t0 + jnp.arange(rows, dtype=jnp.int32)[:, None]) & steps_mask
    quadrant = ti >> (pw - rsh - 2)  # (rows, 1)
    pos = ti & ((1 << (pw - rsh - 2)) - 1)

    if pw - ls < 2:
        # over-wide LUT: addr = pos << (ls-pw+2); strided slice of the
        # doubled ROM from the dynamic base
        stride = 1 << (ls - pw + 2)
        rom2 = jnp.concatenate([rom, rom], axis=0)
        base = (pos[0, 0] * stride).astype(jnp.int32)
        blk = jax.lax.dynamic_slice(
            rom2, (base, jnp.int32(0)), (rows * stride, 2)
        )[::stride]
        mem_cos = blk[:, 0:1]
        mem_sin = blk[:, 1:2]
    else:
        # addr = pos (exact regime) or pos == high bits already (tay1)
        rom2 = jnp.concatenate([rom, rom], axis=0)
        blk = jax.lax.dynamic_slice(
            rom2, (pos[0, 0], jnp.int32(0)), (rows, 2)
        )
        mem_cos = blk[:, 0:1]
        mem_sin = blk[:, 1:2]
        if pw - ls > 2:
            stage = pw - ls - 3
            acnt = jnp.arange(r, dtype=jnp.int32)[None, :]  # (1, R)
            # (rows, 1) x (1, R) rank-1 broadcasts inside the correction
            mem_cos, mem_sin = _tay1(mem_cos, mem_sin, acnt, stage, ls, w)

    mem_cos = jnp.broadcast_to(mem_cos, (rows, r))
    mem_sin = jnp.broadcast_to(mem_sin, (rows, r))
    sw = 32 - w
    wrap_w = (lambda v: (v << sw) >> sw) if sw else (lambda v: v)
    nc, ns = wrap_w(-mem_cos), wrap_w(-mem_sin)
    c = jnp.where(
        quadrant == 0,
        mem_cos,
        jnp.where(quadrant == 1, ns, jnp.where(quadrant == 2, nc, mem_sin)),
    )
    s = jnp.where(
        quadrant == 0,
        mem_sin,
        jnp.where(quadrant == 1, mem_cos, jnp.where(quadrant == 2, ns, nc)),
    )
    return c.reshape(count), s.reshape(count)


def taylor_window_block(n0, count: int, coeffs_q, spec):
    """Gather-free TAYLOR-source window block [n0, n0+count) — bit-exact vs
    ``window_samples`` with ``sin_type="taylor"`` (HLS rounding, 2/3-term
    only; the reference doubles harmonic frequency by instantiating the
    generator one phase bit narrower, src/bh_win_3term.vhd:221-233).

    Alignment: n0 and count must be multiples of the LARGEST harmonic run
    R_1 = 2^(PW-LS-2) (harmonic k's run R_k = R_1 / 2^(k-1) then divides
    it), and count/R_k <= 2^LUT_SIZE for the narrowest harmonic.
    """
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    coeffs_q = tuple(int(c) for c in coeffs_q)
    if len(coeffs_q) not in (2, 3):
        raise ValueError(
            "TAYLOR sin_type supports 2/3-term windows only "
            "(src/win_selector.vhd: 4/5/7-term cores are CORDIC-only)"
        )
    from .pallas.limb import mul_shift30, mul_wide_parts31

    shift = w - 1  # full-scale Taylor cos amplitude 2^(w-1)
    amax = max(abs(c) for c in coeffs_q)
    acc = jnp.full((count,), coeffs_q[0], jnp.int32)
    # At w == 32 the int32 accumulator IS the W-bit register: "saturate"
    # needs wrap tracking (signed overflow counter; each step's |m| < 2^31
    # so true = acc + ov*2^32 exactly — same scheme as
    # pallas/window_kernel.py's w==32 saturate path).
    track_ov = spec.overflow == "saturate" and w == 32
    ov = jnp.zeros((count,), jnp.int32) if track_ov else None
    n0 = jnp.asarray(n0, jnp.int32)
    for k in range(1, len(coeffs_q)):
        pwk = pw - (k - 1)
        mask = (1 << pwk) - 1
        c, _ = taylor_sincos_block(n0 & mask, count, pwk, w, ls)
        if amax.bit_length() + (w - 1) + 1 <= 31:
            m = (coeffs_q[k] * c) >> shift
        elif shift <= 30:
            m = mul_shift30(jnp.int32(coeffs_q[k]), c, shift)
        else:  # shift == 31: full-scale product at w == 32
            m, _ = mul_wide_parts31(coeffs_q[k], c)
        t = -m if k % 2 == 1 else m
        res = acc + t
        if track_ov:
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
    return acc


def taylor_window_range(n0, count: int, coeffs_q, spec):
    """`taylor_window_block` over an arbitrary-length aligned range,
    auto-chunked so every call respects the per-harmonic row bounds (the
    k=2 harmonic runs one phase bit narrower => chunk <= 2^(PW-3)).

    ``n0`` (may be traced) and ``count`` must be multiples of the largest
    harmonic run R_1 = 2^(PW-LS-2).  Drop-in for full-period or sharded
    consecutive generation (``make_window``, ``dist.generate``)."""
    pw = spec.phase_width
    chunk = min(count, 1 << max(pw - 3, 0))
    while count % chunk:
        chunk >>= 1
    n0 = jnp.asarray(n0, jnp.int32)
    parts = [
        taylor_window_block(n0 + i * chunk, chunk, coeffs_q, spec)
        for i in range(count // chunk)
    ]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _tay1(cos_v, sin_v, acnt, stage: int, val_shift: int, w: int):
    """1st-order correction (src/tay1_order.vhd); see golden.tay1_correction.

    The ~(w+21)-bit products (the reference's 48-bit DSP MACCs) run on int32
    lanes via the 15-bit-limb ``mul_shift30`` decomposition whenever
    w <= 30 — the int32-lane path (no int64 emulation).  Shifted
    floor semantics are preserved exactly: the W<19 branch's
    ``(cos<<X - mpi*sin) >> X`` equals ``cos + ((mpi*(-sin)) >> X)``
    identically (low X bits of the accumulator come solely from the
    product), so only a multiply-shift primitive is needed.
    """
    from .pallas.limb import mul_shift30, mul_small_shift

    xshift = 19 + val_shift
    ramb_pi = int(math.floor(math.pi * 2.0 ** (17 - stage) + 0.5))

    # All widths run on int32 lanes: |mpi| < pi*2^18 always
    # (ramb_pi*acnt < pi*2^(20-PW+LS)*2^(PW-LS-2)), so w <= 30 uses the
    # 15-bit-limb mul_shift30 (|sin| < 2^29) and w in {31, 32} the
    # small-multiplier decomposition (|sin| < 2^31).
    mpi = (ramb_pi * acnt).astype(jnp.int32)
    cos_l, sin_l = cos_v.astype(jnp.int32), sin_v.astype(jnp.int32)
    if w <= 30:
        mshift = lambda a, c: mul_shift30(a, c, xshift)
    else:
        mshift = lambda a, c: mul_small_shift(a, c, xshift)
    sw = 32 - w

    wrap_w = lambda v: (v << sw) >> sw

    if w < 19:
        # 48-bit accumulate then slice (no saturation), tay1_order.vhd:180-504
        cos_p = wrap_w(cos_l + mshift(mpi, -sin_l))
        sin_p = wrap_w(sin_l + mshift(mpi, cos_l))
        return cos_p.astype(jnp.int32), sin_p.astype(jnp.int32)

    # W>=19: product sliced to W bits first, W-bit add (wrap), clamp
    # negatives to +max ("scale overflow", tay1_order.vhd:601-617)
    bb_sin = wrap_w(mshift(mpi, sin_l))
    bb_cos = wrap_w(mshift(mpi, cos_l))
    cos_p = wrap_w(cos_l - bb_sin)
    sin_p = wrap_w(sin_l + bb_cos)
    clamp = (1 << (w - 1)) - 1
    cos_p = jnp.where(cos_p < 0, clamp, cos_p)
    sin_p = jnp.where(sin_p < 0, clamp, sin_p)
    return cos_p.astype(jnp.int32), sin_p.astype(jnp.int32)
