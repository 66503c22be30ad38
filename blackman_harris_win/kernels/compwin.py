"""Compensated-float32 window generation — the full −180 dB contract for
float consumers.

``kernels/floatwin.py`` (plain f32) holds only ~−163 dB on BH-7: every
table entry, product and accumulate rounds at 2^-24, and the coherent part
of that rounding sets the spectral floor.  This module removes the
arithmetic rounding *without leaving float32*, so the 7-term −180 dB
contract (`/root/reference/README.md:41,43-53`) reaches float consumers at
fast-mode speed instead of the 2.4x-slower bit-exact int paths.

Scheme — error-free f32 arithmetic by construction (no FMA tricks, no
Dekker two-product; robust to XLA's FMA contraction, which can only make
the exact parts *more* exact):

1.  The angle-addition split of ``floatwin.py``: n = h*2^m + lo and
    w[n] = a0 + sum_k (CH_k[h]*CL_k[lo] - SH_k[h]*SL_k[lo]).
2.  Each table value of a *compensated* harmonic is split against an
    absolute 2^-g grid (g=11): ``hi`` = value rounded to the grid, ``lo``
    = f32 residual (|lo| <= 2^-(g+1), itself 2^-24-relative accurate, so
    the pair represents the f64 value to ~2^-36).
3.  Grid exactness: hi-parts are multiples of 2^-11 with |.| <= 1, so any
    product of two hi-parts is a multiple of 2^-22 with |.| < 1 — exactly
    representable in f32 — and sums of such products stay exact while the
    running value is a multiple of 2^-22 with |.| < 2 (f32 has 24 mantissa
    bits).  The big accumulator ``s`` therefore carries NO rounding error
    at all.
4.  First-order corrections accumulate in a second f32 accumulator ``e``:
    per cos term, ``ch_hi*cl_lo + ch_lo*cl_f`` (with cl_f the plain-f32
    table value) reproduces CH*CL − ch_hi*cl_hi to ~2^-36.  Harmonics with
    |a_k| below the compensation threshold contribute ~a_k*2^-22 error in
    plain f32 and go straight into ``e`` (for BH-7 that is a5=7.8e-4 and
    a6=1.4e-5 — their rounding sits below −186 dB).
5.  Traced code returns the RAW (s, e) pair (its SUM is exact under any
    compilation); the branch-free TwoSum that folds it into a
    non-overlapping (hi, lo) runs host-side (:func:`normalize_pair` — an
    in-jit fold is unsound on this toolchain, see its docstring).

Accuracy (measured, pinned in tests/test_compwin.py): BH-7 pair error vs
the f64 golden < 3e-10; pair spectral floor −180.4 dB at pw=16 (f64:
−180.5).  The folded single-f32 output equals the *format bound*: rounding
the exact f64 window to f32 already floors at −178.6 dB (pw=16) / −180.2
(pw=20), so ≤ −180 in pure f32 needs pw >= 20; the (hi, lo) pair holds the
contract at every pw >= 16.  Downstream float consumers apply the pair as
``frame*hi + frame*lo`` (two FMAs) when the last 17 dB matter, or take
``hi`` — the best window float32 can express.

Cost: 6 multiplies + 6 adds per compensated harmonic per sample (vs 4 for
plain f32, ~28 int ops for the exact int fast mode): BH-7 with 4
compensated + 2 plain harmonics is ~62 f32 ops/sample.  Measured
throughput on the card lives in PERF.md.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .floatwin import DEFAULT_SPLIT, _resolve_coeffs

DEFAULT_THRESH = 2.0 ** -7  # compensate harmonics with |a_k| >= this
GRID_BITS = 11  # absolute split grid 2^-g; products land on 2^-22 exactly


def _grid_round(x: np.ndarray, g: int) -> np.ndarray:
    return (np.round(np.asarray(x, np.float64) * (1 << g)) / (1 << g)).astype(
        np.float32
    )


def _split(x: np.ndarray, g: int):
    """(hi, lo) with hi on the 2^-g grid and lo = f32(x - hi)."""
    hi = _grid_round(x, g)
    return hi, (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(
        np.float32
    )


@lru_cache(maxsize=16)
def _tables_comp(coeffs: tuple, pw: int, m: int, g: int, thresh: float):
    """Compensated + plain table sets.

    Returns (hi_c, lo_c, hi_p, lo_p, a0_hi, a0_lo):
      hi_c (C, nh, 4): ch_hi, ch_lo, sh_hi, sh_lo   (signed a_k folded)
      lo_c (C, nl, 6): cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f
      hi_p (P, nh, 2) / lo_p (P, nl, 2): plain-f32 floatwin-style tables
        for the below-threshold harmonics.
    C or P may be 0.  All values computed in f64 (phases reduced with
    integer mod) and split/rounded once.
    """
    if sum(abs(c) for c in coeffs) > 1.9:
        raise ValueError(
            "sum |a_k| must stay < 1.9 for the exact-grid accumulator "
            f"(got {sum(abs(c) for c in coeffs):.3f})"
        )
    nh, nl, n = 1 << (pw - m), 1 << m, 1 << pw
    h = np.arange(nh)
    lo = np.arange(nl)
    hi_c, lo_c, hi_p, lo_p = [], [], [], []
    for k in range(1, len(coeffs)):
        a = ((-1.0) ** k) * coeffs[k]
        ang_h = (2.0 * math.pi / nh) * np.mod(k * h, nh)
        ang_l = (2.0 * math.pi / n) * np.mod(k * lo, n)
        ch, sh = a * np.cos(ang_h), a * np.sin(ang_h)
        cl, sl = np.cos(ang_l), np.sin(ang_l)
        if abs(coeffs[k]) >= thresh:
            ch_hi, ch_lo = _split(ch, g)
            sh_hi, sh_lo = _split(sh, g)
            cl_hi, cl_lo = _split(cl, g)
            sl_hi, sl_lo = _split(sl, g)
            hi_c.append(np.stack([ch_hi, ch_lo, sh_hi, sh_lo], axis=-1))
            lo_c.append(
                np.stack(
                    [cl_hi, cl_lo, cl.astype(np.float32),
                     sl_hi, sl_lo, sl.astype(np.float32)],
                    axis=-1,
                )
            )
        else:
            hi_p.append(np.stack([ch, sh], axis=-1).astype(np.float32))
            lo_p.append(np.stack([cl, sl], axis=-1).astype(np.float32))

    def _stack(parts, width):
        if parts:
            return np.stack(parts, axis=0)
        return np.zeros((0, 1, width), np.float32)

    a0_hi = float(_grid_round(np.float64(coeffs[0]), g))
    a0_lo = np.float32(coeffs[0] - a0_hi)
    return (_stack(hi_c, 4), _stack(lo_c, 6), _stack(hi_p, 2),
            _stack(lo_p, 2), np.float32(a0_hi), a0_lo)


def _two_sum(s, e):
    """Branch-free TwoSum: (hi, lo) f32 with hi + lo == s + e exactly."""
    hi = s + e
    v = hi - s
    lo = (s - (hi - v)) + (e - v)
    return hi, lo


def normalize_pair(s, e):
    """Host-side (numpy) TwoSum: non-overlapping f32 (hi, lo) with
    hi + lo == s + e exactly and |lo| <= ulp(hi)/2.

    Deliberately NOT a traced/jitted function.  An in-jit TwoSum is
    unsound on this toolchain: XLA duplicates the cheap (s, e) producer
    chain into each consuming fusion with potentially different FMA
    contraction, so TwoSum's several reads can see values differing in the
    last ulp — at rounding-tie samples the returned hi then pairs with the
    *other* rounding's lo and the pair loses exactness (observed: 1.5e-8
    error at 4/16384 samples on CPU XLA; ``lax.optimization_barrier`` does
    not survive to the optimized HLO, and XLA unrolls a length-1 scan).
    The raw (s, e) pair's SUM is exact under any compilation — only the
    *normalization* is rounding-sensitive — so it runs in numpy where
    evaluation is deterministic."""
    s = np.asarray(s, np.float32)
    e = np.asarray(e, np.float32)
    hi, lo = _two_sum(s, e)
    return hi, lo


def pack_tables(hi_c, lo_c, hi_p, lo_p):
    """Pack the stacked tables into 2D arrays whose sliced axis is a plain
    leading/trailing dim (one ``dynamic_slice`` takes a block's h-rows):

      hic (nh, 4C): columns 4k+{0..3} = ch_hi, ch_lo, sh_hi, sh_lo of
        compensated harmonic k;
      loc (6C, nl): rows 6k+{0..5} = cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f;
      hip (nh, 2P) / lop (2P, nl): the plain-harmonic pairs likewise.
    """
    c, nh = hi_c.shape[0], hi_c.shape[1]
    p, nhp = hi_p.shape[0], hi_p.shape[1]
    hic = np.transpose(hi_c, (1, 0, 2)).reshape(nh, 4 * c)
    loc = np.transpose(lo_c, (0, 2, 1)).reshape(6 * c, lo_c.shape[1])
    hip = np.transpose(hi_p, (1, 0, 2)).reshape(nhp, 2 * p)
    lop = np.transpose(lo_p, (0, 2, 1)).reshape(2 * p, lo_p.shape[1])
    return hic, loc, hip, lop


def comp_tile(s, e, hic_blk, loc_t, hip_blk, lop_t):
    """Accumulate all harmonics onto (s, e) tiles.

    hic_blk (rows, 4C) / hip_blk (rows, 2P): h-axis slices of the packed
    tables (:func:`pack_tables`); loc_t (6C, nl) / lop_t (2P, nl).
    """
    for k in range(hic_blk.shape[1] // 4):
        ch_hi = hic_blk[:, 4 * k + 0][:, None]
        ch_lo = hic_blk[:, 4 * k + 1][:, None]
        sh_hi = hic_blk[:, 4 * k + 2][:, None]
        sh_lo = hic_blk[:, 4 * k + 3][:, None]
        cl_hi = loc_t[6 * k + 0][None, :]
        cl_lo = loc_t[6 * k + 1][None, :]
        cl_f = loc_t[6 * k + 2][None, :]
        sl_hi = loc_t[6 * k + 3][None, :]
        sl_lo = loc_t[6 * k + 4][None, :]
        sl_f = loc_t[6 * k + 5][None, :]
        s = s + (ch_hi * cl_hi - sh_hi * sl_hi)  # exact on the 2^-22 grid
        e = e + ((ch_hi * cl_lo + ch_lo * cl_f)
                 - (sh_hi * sl_lo + sh_lo * sl_f))
    for k in range(hip_blk.shape[1] // 2):
        ch = hip_blk[:, 2 * k + 0][:, None]
        sh = hip_blk[:, 2 * k + 1][:, None]
        cl = lop_t[2 * k + 0][None, :]
        sl = lop_t[2 * k + 1][None, :]
        e = e + (ch * cl - sh * sl)
    return s, e


def comp_window_block(n0, rows: int, name_or_coeffs, pw: int,
                      m: int = DEFAULT_SPLIT, g: int = GRID_BITS,
                      thresh: float = DEFAULT_THRESH):
    """Window samples [n0, n0 + rows*2^m) as an f32 (hi, lo) pair, each of
    shape (rows * 2^m,), with hi + lo == w[n] to ~3e-10 absolute (BH-7).

    The pair is the RAW (s, e) accumulator pair — its sum carries the full
    accuracy under any compilation, but the components are not normalized
    (|lo| can reach ~2^-11 and hi alone is NOT the rounded window).
    Consumers apply it as ``x*hi + x*lo``; for non-overlapping components
    or the best-f32 single array use :func:`comp_window` /
    :func:`normalize_pair` (host-side — see normalize_pair's docstring for
    why the fold must not live inside jit).

    ``n0`` may be traced but must be a multiple of 2^m with the block
    inside one period.  Same API shape as ``floatwin.float_window_block``
    so scanned / sharded callers swap fast modes freely.
    """
    if m >= pw:
        raise ValueError("split m must be < phase_width")
    coeffs = _resolve_coeffs(name_or_coeffs)
    hi_c, lo_c, hi_p, lo_p, a0_hi, a0_lo = _tables_comp(
        coeffs, pw, m, g, thresh
    )
    hic_np, loc_np, hip_np, lop_np = pack_tables(hi_c, lo_c, hi_p, lo_p)
    hic_t, loc_t = jnp.asarray(hic_np), jnp.asarray(loc_np)
    hip_t, lop_t = jnp.asarray(hip_np), jnp.asarray(lop_np)
    nl = 1 << m

    h0 = jnp.asarray(n0, jnp.int32) >> m
    zero = jnp.int32(0)

    def slice_h(t):
        if t.shape[1] == 0:
            return jnp.zeros((rows, 0), jnp.float32)
        return jax.lax.dynamic_slice(t, (h0, zero), (rows, t.shape[1]))

    s = jnp.full((rows, nl), a0_hi, jnp.float32)
    e = jnp.full((rows, nl), a0_lo, jnp.float32)
    s, e = comp_tile(s, e, slice_h(hic_t), loc_t, slice_h(hip_t), lop_t)
    return s.reshape(rows * nl), e.reshape(rows * nl)


def comp_window_pair(name_or_coeffs, pw: int, m: int | None = None,
                     g: int = GRID_BITS, thresh: float = DEFAULT_THRESH):
    """Full-period RAW (s, e) pair (traceable — safe inside jit/shard_map;
    see :func:`comp_window_block`).  hi + lo == w[n] to pair accuracy; the
    components are not normalized."""
    if m is None:
        m = min(DEFAULT_SPLIT, pw - 1) if pw > 1 else 0
    if m <= 0:
        # degenerate tiny windows: f64 on host, split once
        coeffs = _resolve_coeffs(name_or_coeffs)
        n = np.arange(1 << pw)
        acc = np.full(n.shape, coeffs[0], np.float64)
        for k, a in enumerate(coeffs[1:], start=1):
            acc += ((-1.0) ** k) * a * np.cos(
                2.0 * math.pi * k * n / (1 << pw)
            )
        hi = acc.astype(np.float32)
        lo = (acc - hi.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)
    rows = 1 << (pw - m)
    return comp_window_block(0, rows, name_or_coeffs, pw, m=m, g=g,
                             thresh=thresh)


def comp_window(name_or_coeffs, pw: int, m: int | None = None,
                pair: bool = False, g: int = GRID_BITS,
                thresh: float = DEFAULT_THRESH):
    """Full-period compensated window, host-finalized (call OUTSIDE jit).

    ``pair=False`` (default) returns the folded (2^pw,) f32 array — the
    best window float32 can express (its floor is the f32 *format* bound:
    −178.6 dB at pw=16 for BH-7); ``pair=True`` returns the normalized,
    non-overlapping (hi, lo) tuple holding the full f64 floor.  The fold /
    normalization runs in numpy (:func:`normalize_pair` explains why)."""
    s, e = comp_window_pair(name_or_coeffs, pw, m=m, g=g, thresh=thresh)
    hi, lo = normalize_pair(s, e)
    if pair:
        return jnp.asarray(hi), jnp.asarray(lo)
    return jnp.asarray(hi)


def comp_window_flops(n_samples: int, coeffs, thresh: float = DEFAULT_THRESH,
                      g: int = GRID_BITS) -> int:
    """No-fusion f32 op model: 12 slots per compensated harmonic (6 mul +
    6 add), 4 per plain harmonic, + 6 for the final TwoSum."""
    coeffs = _resolve_coeffs(coeffs)
    nc = sum(1 for c in coeffs[1:] if abs(c) >= thresh)
    npl = len(coeffs) - 1 - nc
    return n_samples * (12 * nc + 4 * npl + 6)
