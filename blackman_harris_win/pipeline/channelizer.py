"""Polyphase DFT filter-bank channelizer (critically sampled).

Splits a wideband stream into C uniformly spaced channels, each decimated by
C: the classic SDR front-end the reference's Blackman-Harris prototype
windows are built for.  Mapping onto XLA:

- polyphase decomposition is a reshape (no data movement after XLA fusion);
- the per-branch FIR is one grouped convolution (``Precision.HIGHEST``:
  float32 products are never demoted to TF32);
- the cross-branch DFT is a length-C FFT along the branch axis (XLA FFT).

Channel k of frame m:  Y[m, k] = sum_p e^{-j 2 pi p k / C} *
(sum_t h_p[t] x[(m - t) C + p])  — the standard critically-sampled
analysis bank (h_p[t] = h[t C + p]); a tone at +k/C of fs lands in
channel k.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from .fir import design_lowpass


def design_prototype(
    n_channels: int,
    taps_per_branch: int,
    window: str = "bh4",
    data_width: int = 24,
    cutoff_scale: float = 1.0,
) -> np.ndarray:
    """Prototype lowpass for a C-channel bank: cutoff 1/C of Nyquist
    (scaled), length C * taps_per_branch, designed with the framework's
    quantized windows."""
    n_taps = n_channels * taps_per_branch
    return design_lowpass(
        n_taps, cutoff_scale / n_channels, window=window, data_width=data_width
    )


def polyphase_channelize(x, prototype, n_channels: int):
    """x: (..., T) real/complex -> (..., n_frames, n_channels) complex.

    T must be a multiple of n_channels; n_frames = T // C - (taps_per_branch
    - 1) (valid region).  Output channel k is centered at f = k/C * fs.
    """
    c = n_channels
    h = np.asarray(prototype, np.float64)
    if h.size % c:
        raise ValueError("prototype length must be a multiple of n_channels")
    tpb = h.size // c
    x = jnp.asarray(x)
    if x.shape[-1] % c:
        raise ValueError("input length must be a multiple of n_channels")

    lead = x.shape[:-1]
    nf_in = x.shape[-1] // c
    # commutator: sample n -> branch p = n mod C, frame n // C
    xp = x.reshape(lead + (nf_in, c))  # (..., frame, branch)

    # branch FIR: y_p[m] = sum_t h[t*C + p] * x[(m - t)*C + p]
    hp = jnp.asarray(h.reshape(tpb, c), x.real.dtype)  # (t, p)

    def branches_conv(sig):  # sig (..., nf, c) -> (..., nf_out, c)
        # all C branch FIRs as ONE grouped conv (feature_group_count = C):
        # y_p[m] = sum_t h_p[t] x_p[m-t] is a true convolution; XLA's conv
        # primitive correlates, so flip the taps (valid region: m >= tpb-1)
        s = jnp.moveaxis(sig.reshape((-1,) + sig.shape[-2:]), -1, 1)  # (B,c,nf)
        kk = jnp.moveaxis(hp[::-1], -1, 0)[:, None, :]  # (c, 1, tpb) OIW
        y = lax.conv_general_dilated(
            s, kk, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCW", "OIW", "NCW"),
            feature_group_count=c, precision=lax.Precision.HIGHEST,
        )
        y = jnp.moveaxis(y, 1, -1)  # (B, nf_out, c)
        return y.reshape(sig.shape[:-2] + y.shape[-2:])

    if jnp.iscomplexobj(xp):
        y = branches_conv(xp.real) + 1j * branches_conv(xp.imag)
    else:
        y = branches_conv(xp)  # (..., frame, branch)

    # DFT across branches (e^{-j 2 pi p k / C}) so channel k sits at +k/C
    return jnp.fft.fft(y, axis=-1)
