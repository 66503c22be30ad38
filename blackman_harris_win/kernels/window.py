"""Fused cosine-sum window generation (jnp reference path).

The re-expression of the reference's window cores
(``src/hamming_win.vhd``, ``src/bh_win_{3,4,5,7}term.vhd``,
``hls/windows/win_function.cpp:158-422``):

- the reference's K-1 spatially replicated CORDIC instances become a batched
  harmonic loop fused into one traced computation;
- the per-instance phase counters stepping +k mod 2^PHI
  (``src/bh_win_7term.vhd:176-197``) become the closed form
  ``(k * n) mod 2^PHI`` — which is what makes distributed generation
  communication-free: any shard computes its own phase slice
  (SURVEY.md §5 "Long-context / sequence parallelism");
- the elaboration-time ``win_selector`` dispatch becomes a name lookup; the
  runtime HLS-style selector is :func:`win_function`.

Two rounding modes (see ``WindowSpec``): "hls" (the coherent functional spec)
and "rtl" (the VHDL cores' two round-half-up stages, raw AA-port semantics).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.config import CordicSpec, WindowSpec
from ..core.fixedpoint import min_int_dtype
from ..windows import catalog
from . import cordic as _cordic


def _int_lane(bits: int):
    """Pick an integer lane dtype that can exactly hold `bits` bits, failing
    loudly when int64 is requested but x64 is disabled (jnp would otherwise
    *silently* truncate to int32)."""
    if bits <= 32:
        return jnp.int32
    if bits <= 64:
        if not jax.config.read("jax_enable_x64"):
            raise ValueError(
                f"this configuration needs {bits}-bit integer lanes; enable "
                "jax_enable_x64 or use the two-limb int32 datapaths "
                "(kernels.pallas) which run on int32 lanes"
            )
        return jnp.int64
    raise ValueError(f"{bits}-bit lanes unsupported; use the two-limb path")


def _harmonic_cos(n, k: int, spec: WindowSpec):
    """cos of harmonic k at sample indices n.

    CORDIC: closed-form phase (k*n) mod 2^PW into one generator (amplitude
    2^(W-2)).  TAYLOR: the reference doubles frequency by instantiating the
    generator one phase bit narrower (src/bh_win_3term.vhd:221-233), so
    harmonic k=2^j uses taylor at PW-j with phase n mod 2^(PW-j) (amplitude
    2^(W-1)); only 2/3-term windows support TAYLOR, matching
    src/win_selector.vhd:93-147.
    """
    pw = spec.phase_width
    if spec.sin_type == "cordic":
        flavor = "hls" if spec.rounding == "hls" else "dds"
        cs = CordicSpec(pw, spec.data_width, flavor, spec.precision)
        c, _ = _cordic.cordic_sincos((k * n) & ((1 << pw) - 1), cs)
        return c
    from . import taylor as _taylor

    if k not in (1, 2):
        raise ValueError(
            "TAYLOR sin_type supports 2/3-term windows only "
            "(src/win_selector.vhd: 4/5/7-term cores are CORDIC-only)"
        )
    pwk = pw - (k - 1)
    c, _ = _taylor.taylor_sincos(
        n & ((1 << pwk) - 1), pwk, spec.data_width, spec.lut_size
    )
    return c


def window_samples(n, coeffs_q, spec: WindowSpec):
    """Quantized window samples at indices ``n`` (any shape, ints).

    ``coeffs_q``: integer coefficients (a0..aK), e.g. from
    ``catalog.get(name).quantized(data_width)``.  Returns signed
    data_width-bit values in an int32/int64 carrier.
    """
    pw, w = spec.phase_width, spec.data_width
    if spec.sin_type == "taylor2":
        from .fastwin import window_values_fast

        return window_values_fast(jnp.asarray(n, jnp.int32), coeffs_q, spec)
    if spec.rounding == "hls":
        if (
            spec.sin_type == "cordic"
            and not jax.config.read("jax_enable_x64")
            and w <= 32
            and pw <= 31  # (k*n) int32 wrap is exact under the 2^pw mask
        ):
            amax = max(abs(int(c)) for c in coeffs_q)
            if max(amax.bit_length() + (w - 2) + 1, w + 3) > 32:
                # int64 lanes unavailable (x64 off): route through the
                # bit-exact two-limb int32 datapath
                # (kernels.pallas.window_kernel)
                from .pallas.window_kernel import window_values

                return window_values(jnp.asarray(n, jnp.int32), coeffs_q, spec)
        return _window_hls(n, coeffs_q, spec)
    if (
        spec.sin_type in ("cordic", "taylor")
        and not jax.config.read("jax_enable_x64")
        and w <= 32
        and pw <= 31  # (k*n) int32 wrap is exact under the 2^pw mask
    ):
        amax = max(abs(int(c)) for c in coeffs_q)
        cos_bits = (w - 2) if spec.sin_type == "cordic" else (w - 1)
        state = w + spec.precision if spec.sin_type == "cordic" else 0
        if max(amax.bit_length() + cos_bits + 1, w + 2, state) > 32:
            # int64 lanes unavailable (x64 off): the VHDL rounding contract
            # runs on the int32-lane datapath (radix-4 W+2-bit tree, limb
            # slices)
            from .pallas.window_kernel import window_values

            return window_values(jnp.asarray(n, jnp.int32), coeffs_q, spec)
    return _window_rtl(n, coeffs_q, spec)


def _i32_products_ok(prod_bits: int, w: int) -> bool:
    """True when int64 lanes are unavailable but the per-term products can
    run exactly on int32 via the limb decompositions (mul_shift30 up to
    2^30-magnitude operands; mul_wide_parts31 for the full-scale w=32
    Taylor source)."""
    return (
        prod_bits > 32
        and not jax.config.read("jax_enable_x64")
        and w <= 32
    )


def _window_hls(n, coeffs_q, spec: WindowSpec):
    """HLS semantics: ``w[n] = a0 - m1 + m2 - ...``,
    ``m_k = (a_k * cos_k) >> (W-2)`` (hls/windows/win_function.cpp:361-375).

    The product a_k(W-1 bits) * cos(W-2 bits magnitude) needs ~2W-3 bits:
    an int64 lane when available, else (x64 off) the exact 15-bit-limb
    int32 product (``limb.mul_shift30``) — every shifted term m_k < 2^(w-1) and
    the accumulate only ever feeds a <= w-bit wrap, so int32 lanes carry the
    TAYLOR-source windows too (w <= 30; wide-state CORDIC configs route to
    kernels.pallas.window_values before reaching here).
    """
    pw, w = spec.phase_width, spec.data_width
    # Exact product width: |a_k| * cos magnitude + sign (cos amplitude is
    # 2^(w-2) for CORDIC, 2^(w-1) for the full-scale Taylor generator).
    cos_bits = (w - 2) if spec.sin_type == "cordic" else (w - 1)
    amax = max(abs(int(c)) for c in coeffs_q)
    prod_bits = amax.bit_length() + cos_bits + 1
    i32_prod = _i32_products_ok(prod_bits, w)
    pdt = jnp.int32 if i32_prod else _int_lane(max(prod_bits, w + 1))

    # Phase lane: int64 when available gives headroom for the k*n
    # products; on int32-only backends the ring wrap (mod 2^32) makes the
    # masked phase exact for pw <= 31 (2^pw | 2^32), so int32 suffices.
    if jax.config.read("jax_enable_x64"):
        n = jnp.asarray(n, _int_lane(pw + 3))
    elif pw <= 31:
        n = jnp.asarray(n, jnp.int32)
    else:
        raise ValueError("int32-lane windows support phase_width <= 31")

    acc = jnp.full(n.shape, int(coeffs_q[0]), pdt)
    # w == 32 saturate on int32 lanes: the accumulator IS the W-bit
    # register, so clipping after the fact is a no-op — track signed
    # overflow per step instead (each |m| < 2^31, so true value ==
    # acc + ov*2^32 exactly; same scheme as pallas/window_kernel.py).
    track_ov = spec.overflow == "saturate" and w == 32 and i32_prod
    ov = jnp.zeros(n.shape, jnp.int32) if track_ov else None
    shift = w - 2 if spec.sin_type == "cordic" else w - 1
    for k in range(1, len(coeffs_q)):
        c = _harmonic_cos(n, k, spec)
        if i32_prod:
            from .pallas.limb import mul_shift30, mul_wide_parts31

            if shift <= 30:  # operands < 2^30: 15-bit-limb product
                m = mul_shift30(
                    jnp.int32(coeffs_q[k]), c.astype(jnp.int32), shift
                )
            else:  # shift == 31: full-scale Taylor at w == 32
                m, _ = mul_wide_parts31(int(coeffs_q[k]), c.astype(jnp.int32))
        else:
            m = (jnp.asarray(coeffs_q[k], pdt) * c.astype(pdt)) >> shift
        t = -m if k % 2 == 1 else m
        res = acc + t
        if track_ov:
            of = (~(acc ^ t) & (acc ^ res)) >> 31
            ov = ov + jnp.where(of != 0, (acc >> 31) | 1, 0)
        acc = res

    if track_ov:
        imax = jnp.int32((1 << 31) - 1)
        imin = jnp.int32(-(1 << 31))
        out = jnp.where(ov > 0, imax, jnp.where(ov < 0, imin, acc))
    elif spec.overflow == "saturate":
        out = jnp.clip(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    else:  # wrap: win_t cast (ap_int<W>)
        nb = jnp.iinfo(pdt).bits
        out = (acc << (nb - w)) >> (nb - w)
    return out


def _window_rtl(n, coeffs_q, spec: WindowSpec):
    """VHDL datapath semantics with raw AA-port coefficients
    (src/bh_win_3term.vhd:257-306, src/hamming_win.vhd:194-231):
    product slice [2W-2:W-2] -> W+1 bits, round-half-up off bit 0 -> W bits,
    alternating adder tree in W+2 bits (W+1 for 2-term), final round-half-up
    off bit 1 (bit 0 for 2-term) -> W bits."""
    pw, w = spec.phase_width, spec.data_width
    nterms = len(coeffs_q)
    cos_bits = (w - 2) if spec.sin_type == "cordic" else (w - 1)
    amax = max(abs(int(c)) for c in coeffs_q)
    prod_bits = amax.bit_length() + cos_bits + 1
    # w <= 30 only: the W+2-bit adder tree must fit the int32 lane (the
    # radix-4 tree for w in {31, 32} lives in pallas.window_values_rtl,
    # which window_samples routes to before reaching here)
    i32_prod = _i32_products_ok(prod_bits, w) and w <= 30
    pdt = jnp.int32 if i32_prod else _int_lane(max(prod_bits, w + 2))
    nb = jnp.iinfo(pdt).bits
    wrap = lambda v, width: (v << (nb - width)) >> (nb - width)

    # Phase lane: int64 when available gives headroom for the k*n
    # products; on int32-only backends the ring wrap (mod 2^32) makes the
    # masked phase exact for pw <= 31 (2^pw | 2^32), so int32 suffices.
    if jax.config.read("jax_enable_x64"):
        n = jnp.asarray(n, _int_lane(pw + 3))
    elif pw <= 31:
        n = jnp.asarray(n, jnp.int32)
    else:
        raise ValueError("int32-lane windows support phase_width <= 31")

    bs = []
    for k in range(1, nterms):
        c = _harmonic_cos(n, k, spec)
        if i32_prod:
            from .pallas.limb import mul_shift30

            # the (w+1)-bit slice fits int32 for w <= 30 (|r| < 2^w)
            r = mul_shift30(jnp.int32(coeffs_q[k]), c.astype(jnp.int32), w - 2)
        else:
            p = jnp.asarray(coeffs_q[k], pdt) * c.astype(pdt)
            r = wrap(p >> (w - 2), w + 1)  # mult_p(2W-2 downto W-2)
        bs.append(wrap((r >> 1) + (r & 1), w))  # round-half-up off bit 0

    a0 = jnp.asarray(coeffs_q[0], pdt)
    if nterms == 2:  # hamming_win.vhd:211-231
        pp = wrap(a0 - bs[0], w + 1)
        out = wrap((pp >> 1) + (pp & 1), w)
    else:
        acc = jnp.broadcast_to(a0, n.shape).astype(pdt)
        for k, b in enumerate(bs, start=1):
            acc = acc - b if k % 2 == 1 else acc + b
        pp = wrap(acc, w + 2)
        out = wrap((pp >> 2) + ((pp >> 1) & 1), w)  # round off bit 1

    if spec.overflow == "saturate":
        out = jnp.clip(out, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    return out


def make_window(name: str, spec: WindowSpec, coeffs=None):
    """Generate the full 2^phase_width-point quantized window for a named
    coefficient set (the user-facing ``win_selector`` equivalent,
    src/win_selector.vhd:93-199 — but runtime-dispatchable).

    TAYLOR-source HLS windows route through the gather-free block kernel
    (``taylor.taylor_window_block``, bit-exact vs ``window_samples``;
    15.7 vs 0.3 Gsamp/s at bulk sizes) in eighth-period chunks — sized so
    the k=2 harmonic (one phase bit narrower => double the rows per
    sample) stays within its per-quadrant ROM-row bound."""
    d = catalog.get(name)
    coeffs_q = coeffs if coeffs is not None else d.quantized(spec.data_width)
    if (
        spec.sin_type == "taylor"
        and spec.rounding == "hls"
        and len(coeffs_q) in (2, 3)
        and spec.phase_width >= 5
    ):
        from .taylor import taylor_window_range

        return taylor_window_range(0, spec.n, coeffs_q, spec)
    n = jnp.arange(spec.n)
    return window_samples(n, coeffs_q, spec)


def rtl_cordic_coeffs(coeffs_q) -> tuple[int, ...]:
    """Corrected AA-port values for the RTL (VHDL) cores with the CORDIC
    source: **AA0 halved** (round-half-up).

    The VHDL product datapath (slice [2W-2:W-2] then round-half-up off
    bit 0, src/hamming_win.vhd:195-208) is scaled for a *full-scale*
    2^(W-1) cosine source — the TAYLOR generator (ROM entries
    x(2^(W-1)-1), src/taylor_sincos.vhd:101-102).  The CORDIC source's
    amplitude is 2^(W-2) (half: gain seed (1/K)/2, src/cordic_dds.vhd:97),
    so with same-scale AA ports every harmonic term lands at a_k/2 against
    a full a0 and the window grows a massive DC pedestal (measured: BH-7
    W=32 floors at -39 dB; the reference's own testbench quantizes each
    term count at a different ad-hoc scale and does not resolve the
    convention, src/tb/tb_windows.vhd:64-127).  Because coefficients are
    runtime ports, the correction is pure data: halving AA0 restores
    cancellation and the published floors (BH-4 W=17 -> -95.5 dB, BH-7
    W=32 -> -179.4, tests/test_window.py) at output scale
    sum(q)/8 for 3+-term cores (one extra headroom bit vs the TAYLOR
    source's sum(q)/4).
    """
    q = tuple(int(c) for c in coeffs_q)
    return ((q[0] + 1) >> 1,) + q[1:]


def win_function(sel: int, n, spec: WindowSpec):
    """HLS runtime selector semantics (hls/windows/win_function.cpp:380-422):
    selector code -> window; unknown code -> zeros (win_empty)."""
    if sel not in catalog.HLS_SEL:
        return jnp.zeros(jnp.shape(n), min_int_dtype(spec.data_width))
    d = catalog.get(catalog.HLS_SEL[sel])
    return window_samples(n, d.quantized(spec.data_width), spec)


def window_block(n0: int, block_len: int, coeffs_q, spec: WindowSpec):
    """A contiguous block [n0, n0+block_len) of the window — the streaming /
    sharded building block (no host ever needs the full window).  TAYLOR/HLS
    configs with aligned blocks route through the gather-free block kernel
    (kernels/taylor.py; ~50x the indexed gather at bulk sizes)."""
    coeffs_q = tuple(int(c) for c in coeffs_q)
    if (
        spec.sin_type == "taylor"
        and spec.rounding == "hls"
        and len(coeffs_q) in (2, 3)
        and spec.phase_width >= 5
    ):
        r1 = 1 << max(spec.phase_width - spec.lut_size - 2, 0)
        # The block kernel requires n0 to be R_1-aligned; a traced n0 cannot
        # be checked here (taylor_sincos_block's alignment assert is static
        # only), so traced offsets take the indexed window_samples path —
        # callers with provably aligned traced offsets (dist/generate.py)
        # call taylor_window_range directly.
        if block_len % r1 == 0 and isinstance(n0, int) and n0 % r1 == 0:
            from .taylor import taylor_window_range

            return taylor_window_range(n0, block_len, coeffs_q, spec)
    n = n0 + jnp.arange(block_len)
    return window_samples(n, coeffs_q, spec)
