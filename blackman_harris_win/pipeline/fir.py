"""Windowed-sinc FIR design + polyphase decimating FIR.

The reference's windows exist to weight FFT/FIR front-ends (SURVEY.md §1 L3:
win_selector feeds "a user design, e.g. an FFT front-end").  This module is
that user design:

- prototype lowpass taps are designed with the framework's own on-the-fly
  quantized windows (no stored window tables — the window is generated by
  the CORDIC/Taylor engines at design time);
- the decimating FIR runs as an overlapped-frames x taps matmul, or as
  ``lax.conv_general_dilated`` with stride = decimation at bulk sizes —
  never as a sample-serial MAC chain;
- the sharded variant shards time blocks with a left halo of (taps-1)
  samples over ppermute (``dist.halo``).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import WindowSpec
from ..kernels.window import window_samples
from ..windows import catalog

#: Largest overlapped-frames temporary (elements, all leading rows counted)
#: the matmul form of :func:`decimating_fir` may build: 2^25 f32 = 128 MB.
FRAMES_CAP = 1 << 25


def design_lowpass(
    num_taps: int,
    cutoff: float,
    window: str = "bh4",
    data_width: int = 24,
) -> np.ndarray:
    """Windowed-sinc lowpass prototype (float64 taps, unity DC gain).

    ``cutoff`` in (0, 1) as a fraction of Nyquist.  The window weights come
    from the framework's fixed-point generator at ``data_width`` (so the
    design inherits the reference's quantized-window semantics) on a
    2^ceil(log2(num_taps)) grid, sampled at the tap positions.
    """
    if not 0 < cutoff < 1:
        raise ValueError("cutoff must be in (0, 1) (fraction of Nyquist)")
    pw = max(4, int(np.ceil(np.log2(max(num_taps, 2)))))
    spec = WindowSpec(pw, data_width, overflow="saturate")
    d = catalog.get(window)
    n_grid = 1 << pw
    # sample the periodic window at tap positions (symmetric windowing);
    # ensure_compile_time_eval: this is design-time host math and must
    # stay concrete even when the caller (e.g. ddc()) runs under jit
    pos = (np.arange(num_taps) * n_grid) // num_taps
    with jax.ensure_compile_time_eval():
        wq = np.asarray(
            window_samples(jnp.asarray(pos), d.quantized(data_width), spec),
            np.float64,
        )
    w = wq / (2.0 ** (data_width - d.shift) - 1.0)

    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff * w
    return h / h.sum()


def decimating_fir(x, taps, decim: int):
    """y[m] = sum_t h[t] * x[m*decim + t] (valid region only).

    x: (..., T) float; taps: (n_taps,).  Output length:
    (T - n_taps) // decim + 1.

    When n_taps and T are multiples of ``decim`` and the overlapped-frames
    temporary (every leading batch row's M x n_taps frames) stays within
    ``FRAMES_CAP`` elements, this runs as a frames x taps matmul; otherwise
    as the strided ``conv_general_dilated`` with feature size 1.  Both
    contractions ask for ``Precision.HIGHEST``: a float32 product left at
    the default precision may run in TF32 on GPUs (~3 decimal digits).
    """
    x = jnp.asarray(x)
    taps = jnp.asarray(taps, x.dtype)
    lead = x.shape[:-1]
    t = x.shape[-1]
    n_taps = taps.shape[0]
    hi = lax.Precision.HIGHEST
    if n_taps % decim == 0 and t % decim == 0 and t >= n_taps:
        m_total = (t - n_taps) // decim + 1
        if math.prod(lead) * m_total * n_taps <= FRAMES_CAP:
            from .spectral import frames_view

            fr = frames_view(x, n_taps, decim)  # (..., M, n_taps)
            return jnp.einsum("...mt,t->...m", fr, taps, precision=hi)
    xr = x.reshape((-1, 1, t))  # (batch, feature=1, spatial)
    # XLA's conv primitive correlates, which is exactly y[m]=sum h[t]x[mD+t]
    k = taps.reshape((1, 1, -1))  # OIW
    y = lax.conv_general_dilated(
        xr, k, window_strides=(decim,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"), precision=hi,
    )
    return y.reshape(lead + (y.shape[-1],))


def make_sharded_decimating_fir(mesh: Mesh, taps, decim: int):
    """Sharded decimating FIR over a (channels, blocks) mesh.

    Input (C, T) sharded P('channels', 'blocks'); each time shard prepends a
    left halo of len(taps)-decim samples from its neighbor (circular).
    Causal streaming alignment: output m is the tap window *ending* at
    global sample m*decim+decim-1, i.e. y[m] = sum_t h[t] x[(m*decim -
    (n_taps-decim) + t) mod T].  Block length must be a multiple of
    ``decim``; output stays sharded over 'blocks'.
    """
    from ..dist.halo import with_left_halo

    taps = np.asarray(taps)
    halo = len(taps) - decim
    if halo < 0:
        raise ValueError("decimation larger than filter not supported")

    def shard_fn(x):  # (C_l, B)
        if x.shape[-1] % decim:
            raise ValueError("shard block must be a multiple of decim")
        xh = with_left_halo(x, halo, "blocks", circular=True)
        return decimating_fir(xh, taps, decim)

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("channels", "blocks"),
        out_specs=P("channels", "blocks"),
    )
