"""Quadrature (FM) demodulation on the fixed-point atan2 engine.

The reference ships ``cordic_atan2`` for exactly this ("needed for the
demod/quadrature end of the target SDR chain", SURVEY.md §2 #4).  Two
demodulators:

- :func:`fm_demod_phase`: unwrap-free phase-difference demod —
  d[n] = wrap(phi[n] - phi[n-1]) with phi from :func:`atan2_fixed`.
- :func:`fm_demod_conj`: conjugate-product demod — the discriminator
  atan2(Im(z[n] conj(z[n-1])), Re(...)), more robust near the +-pi seam.

Both return the instantaneous frequency in angle LSBs (pi == 2^(AW-1));
multiply by fs / 2^AW for Hz.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..kernels.cordic import atan2_fixed


def phase_wrap(d, angle_width: int):
    """Wrap angle differences into [-pi, pi) == [-2^(AW-1), 2^(AW-1))."""
    full = 1 << angle_width
    half = 1 << (angle_width - 1)
    return ((d + half) & (full - 1)) - half


def fm_demod_phase(i, q, input_width: int, angle_width: int = 24):
    """Instantaneous frequency from I/Q integer streams (..., T) ->
    (..., T-1) in angle LSBs."""
    phi = atan2_fixed(q, i, input_width, angle_width)
    d = phi[..., 1:] - phi[..., :-1]
    return phase_wrap(d, angle_width)


def fm_demod_conj(i, q, input_width: int, angle_width: int = 24):
    """Conjugate-product discriminator.  z[n] * conj(z[n-1]) =
    (i1 i0 + q1 q0) + j (q1 i0 - i1 q0); products need 2*input_width-1 bits
    — inputs are re-quantized to <= 15 bits so products stay in int32 lanes
    (mirrors how a DSP48-based discriminator would truncate)."""
    i = jnp.asarray(i)
    q = jnp.asarray(q)
    drop = max(0, input_width - 15)
    i15, q15 = (i >> drop).astype(jnp.int32), (q >> drop).astype(jnp.int32)
    iw15 = input_width - drop

    i0, i1 = i15[..., :-1], i15[..., 1:]
    q0, q1 = q15[..., :-1], q15[..., 1:]
    re = i1 * i0 + q1 * q0  # <= 2^(2*iw15-1) < 2^31
    im = q1 * i0 - i1 * q0
    # products fit 2*iw15 bits; atan2 datapath consumes low AW-1 bits, so
    # scale down into the engine's input range
    eff = 2 * iw15
    shift = max(0, eff - (angle_width - 1))
    return atan2_fixed(im >> shift, re >> shift, angle_width, angle_width)
