"""Float32 outer-product window generation — the native fast path for
float consumers.

Every downstream pipeline in this framework (Welch ``pipeline/spectral.py``,
STFT/WOLA ``pipeline/stft.py``, the fused gen+FFT deployment) multiplies
frames by a *float32* window: the quantized integer window is generated,
then converted and scaled (``spectral.py:80``).  When the consumer is
float anyway, generating the window natively in f32 is the idiomatic
accelerator move — the reference has no analogue (its consumers are
integer FFT cores; the float model lives only in Octave,
``math/window_test.m:122-138``), so this is a capability this library adds
on top of parity.

Scheme: the same angle-addition split as ``outerwin.py`` (the int fast
mode; tables over the high/low index halves, signed coefficients folded
into the hi tables), but in float32:

    n = h * 2^m + lo
    w[n] = a0 + sum_k ( CH_k[h] * CL_k[lo] - SH_k[h] * SL_k[lo] )

with CH_k = (-1)^k a_k cos(theta_hi), etc., rounded once from float64.
Per sample per harmonic that is two multiplies, one subtract and one
accumulate add — ~4 f32 ops against ~28 int ops for the exact int
fast mode and ~380 for the bit-exact two-limb CORDIC path.  No gathers,
no iteration loop, all rank-1 broadcasts.

Accuracy: each table entry carries one f64->f32 rounding (2^-24 relative),
each product one more; the per-sample error is ~ K * 2^-23 absolute
(unit-amplitude window, measured max 1.9e-7 across the catalog).  The
*coherent* rounding part sets the spectral floor: measured at pw=16
(pinned in tests/test_floatwin.py), the f32 floor EQUALS the f64 floor
for every window through 5 terms —

    hamming -45.1, bh4 -94.8, nuttall -101.0, bh5 -125.4 dB
    bh7 -163.2 dB (f64: -180.5 — the one window f32 cannot fully hold)

i.e. float32 serves the entire catalog except the last ~17 dB of the
7-term contracts; for the full -180 dB use the exact int paths
(``outerwin.py``, ``pallas/window_kernel.py``).  The acceptance
methodology is the reference's own spectral one (math/window_test.m,
SURVEY.md §4.3).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_SPLIT = 11  # lo axis 2^11 = 2048 lanes


def _resolve_coeffs(name_or_coeffs) -> tuple[float, ...]:
    if isinstance(name_or_coeffs, str):
        from ..windows import catalog

        return catalog.get(name_or_coeffs).coeffs
    return tuple(float(c) for c in name_or_coeffs)


@lru_cache(maxsize=16)
def _tables_f32(coeffs: tuple, pw: int, m: int):
    """(hi, lo) float32 tables: hi (K-1, 2^(pw-m), 2) with (-1)^k a_k
    folded; lo (K-1, 2^m, 2) unit amplitude.  Values computed in float64
    (phase reduced exactly with integer mod) and rounded once to f32."""
    nh, nl = 1 << (pw - m), 1 << m
    ks = np.arange(1, len(coeffs))
    sgn = np.where(ks % 2 == 1, -1.0, 1.0)
    a = np.asarray(coeffs[1:], np.float64)[:, None] * sgn[:, None]

    h = np.arange(nh)
    kh = np.mod(np.outer(ks, h), nh)  # theta_hi = 2*pi*(k*h mod nh)/nh
    ang_h = (2.0 * math.pi / nh) * kh
    hi = np.stack(
        [a * np.cos(ang_h), a * np.sin(ang_h)], axis=-1
    ).astype(np.float32)

    lo = np.arange(nl)
    klo = np.mod(np.outer(ks, lo), 1 << pw)
    ang_l = (2.0 * math.pi / (1 << pw)) * klo
    lo_t = np.stack([np.cos(ang_l), np.sin(ang_l)], axis=-1).astype(np.float32)
    return hi, lo_t


def float_window_block(n0, rows: int, name_or_coeffs, pw: int,
                       m: int = DEFAULT_SPLIT):
    """Window samples [n0, n0 + rows*2^m) as a (rows * 2^m,) float32 array
    at unit amplitude (w[0] ~ sum of signed coefficients; peak <= 1).

    ``n0`` may be traced but must be a multiple of 2^m with the block
    inside one period.  Mirrors ``outerwin.window_block_outer``'s API so
    sharded / scanned callers swap between the int and float fast modes.
    """
    if m >= pw:
        raise ValueError("split m must be < phase_width")
    coeffs = _resolve_coeffs(name_or_coeffs)
    hi_np, lo_np = _tables_f32(coeffs, pw, m)
    hi_t, lo_t = jnp.asarray(hi_np), jnp.asarray(lo_np)
    nl = 1 << m

    h0 = jnp.asarray(n0, jnp.int32) >> m
    zero = jnp.int32(0)
    hi_blk = jax.lax.dynamic_slice(
        hi_t, (zero, h0, zero), (hi_t.shape[0], rows, 2)
    )  # (K-1, rows, 2)

    acc = jnp.full((rows, nl), np.float32(coeffs[0]), jnp.float32)
    for i in range(hi_t.shape[0]):
        ch = hi_blk[i, :, 0][:, None]
        sh = hi_blk[i, :, 1][:, None]
        cl = lo_t[i, :, 0][None, :]
        sl = lo_t[i, :, 1][None, :]
        acc = acc + (ch * cl - sh * sl)
    return acc.reshape(rows * nl)


def float_window(name_or_coeffs, pw: int, m: int | None = None):
    """Full-period (2^pw,) float32 window, generated on the fly (no stored
    table of window values; only the 2^(pw-m) + 2^m trig tables)."""
    if m is None:
        m = min(DEFAULT_SPLIT, pw - 1) if pw > 1 else 0
    if m <= 0:
        # degenerate tiny windows: evaluate directly in f64 on host
        coeffs = _resolve_coeffs(name_or_coeffs)
        n = np.arange(1 << pw)
        acc = np.full(n.shape, coeffs[0], np.float64)
        for k, a in enumerate(coeffs[1:], start=1):
            acc += ((-1.0) ** k) * a * np.cos(2.0 * math.pi * k * n / (1 << pw))
        return jnp.asarray(acc, jnp.float32)
    rows = 1 << (pw - m)
    return float_window_block(0, rows, name_or_coeffs, pw, m=m)


def float_window_flops(n_samples: int, n_terms: int) -> int:
    """No-fusion f32 op model: 2 multiplies + 2 adds per harmonic per
    sample (the FMA pairs cover it in 2 slots; this counts 4, matching the
    int model's no-fusion convention)."""
    return n_samples * (n_terms - 1) * 4
