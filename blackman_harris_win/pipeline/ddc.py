"""Digital downconverter (DDC): fixed-point CORDIC NCO + integer I/Q mixer
+ decimating lowpass FIR.

This is the role the reference's CORDIC is *named* for — ``cordic_dds48`` is
titled "sine and cosine generator (DDS)" (src/cordic_dds48.vhd:9-14) — and
the classic deployment of such a DDS: translate a band of interest to
baseband and decimate.  Structure:

- the NCO phase is closed-form ``(n * freq_word) mod 2^PW`` (the int32
  product wraps mod 2^32, and 2^PW | 2^32, so the masked value is exact for
  any n) — the same phase-splitting trick as the window cores, which makes
  the sharded DDC communication-free up to the FIR halo;
- the NCO itself is the dds48 rotation engine (int32-lane two-limb datapath
  when x64 is off, ``kernels/pallas/cordic_wide.py``).  Downconversion needs
  e^{-j2 pi f n} = cos - j sin, and the reference's dds48 DT_SIN axis quirk
  carries **-sin** natively (src/cordic_dds48.vhd, pinned by
  test_cordic.py:test_dds48_sin_axis_quirk) — the quirk is the correct
  mixer phase, used as-is;
- the mixer is integer: 15-bit input x 2^(W-2)-amplitude NCO products stay
  on int32 lanes (the DSP48 analogue);
- the decimating lowpass reuses ``pipeline/fir.py``, with the framework's
  own quantized windows weighting the prototype.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import CordicSpec
from ..kernels.cordic import cordic_sincos
from .fir import decimating_fir, design_lowpass

#: input quantization of the integer mixer (ADC-like front end)
MIX_IN_BITS = 15


def freq_word(freq: float, phase_width: int) -> int:
    """NCO tuning word: round(freq * 2^PW) phase steps/sample (freq in
    cycles/sample)."""
    return int(round(freq * (1 << phase_width))) & ((1 << phase_width) - 1)


def nco_iq(n, fw: int, phase_width: int, data_width: int,
           flavor: str = "dds48"):
    """(cos, -sin) of the NCO at sample indices ``n`` (int32), amplitude
    2^(W-2): the pre-rotated engines' native output pair (DT_COS, DT_SIN)
    — the reference's -sin axis quirk IS the downconversion mixer phase.

    ``flavor``: "dds48" (the max-precision DDS the role is named for) or
    "scaled" (the area-optimized variant, src/cordic_dds_scaled.vhd —
    same pre-rotation architecture and -sin axis, SEL_SIZE internal
    width; single int32 limb at mixer-legal data widths)."""
    if flavor not in ("dds48", "scaled"):
        raise ValueError("NCO flavor must be 'dds48' or 'scaled'")
    ph = (jnp.asarray(n, jnp.int32) * jnp.int32(fw)) & (
        (1 << phase_width) - 1
    )
    c, ns = cordic_sincos(ph, CordicSpec(phase_width, data_width, flavor))
    return c.astype(jnp.int32), ns.astype(jnp.int32)


def mix_iq_int(xq, n, fw: int, phase_width: int, data_width: int,
               flavor: str = "dds48"):
    """Integer I/Q mixer on int32 lanes: ``xq`` int32 samples with
    |xq| < 2^MIX_IN_BITS at global indices ``n``.  Returns raw int32
    (i, q) products (scale 2^(W-2) x input scale); the product needs
    MIX_IN_BITS + (W-2) + 1 bits and must fit the int32 lane."""
    if MIX_IN_BITS + (data_width - 2) + 1 > 31:
        raise ValueError(
            f"mixer product needs {MIX_IN_BITS + data_width - 1} bits; "
            f"use data_width <= {32 - MIX_IN_BITS + 1} for int32 lanes"
        )
    c, ns = nco_iq(n, fw, phase_width, data_width, flavor)
    return xq * c, xq * ns


def ddc(x, freq: float, decim: int, taps=64, phase_width: int = 20,
        data_width: int = 16, cutoff: float | None = None,
        window: str = "bh4", n0: int = 0, flavor: str = "dds48"):
    """Single-device DDC: float stream (..., T) -> complex baseband as a
    stacked (2, ..., T//decim) float32 array (I, Q), decimated by ``decim``.

    The input is quantized to MIX_IN_BITS (the ADC-like integer front end),
    mixed with the integer NCO on int32 lanes, rescaled once to float32,
    and lowpass-decimated (prototype: windowed sinc at ``cutoff``
    fraction-of-Nyquist post-decimation, default 0.8/decim of input
    Nyquist).  ``n0``: global index of x[..., 0] (streaming blocks).
    """
    x = jnp.asarray(x, jnp.float32)
    t = x.shape[-1]
    if t % decim:
        raise ValueError(f"T = {t} must be a multiple of decim = {decim}")
    fw = freq_word(freq, phase_width)
    h = taps if hasattr(taps, "__len__") else design_lowpass(
        int(taps), (cutoff if cutoff is not None else 0.8 / decim),
        window=window)

    amp_in = float((1 << MIX_IN_BITS) - 1)
    xq = jnp.round(x * amp_in).astype(jnp.int32)
    n = n0 + jnp.arange(t, dtype=jnp.int32)
    mi, mq = mix_iq_int(xq, n, fw, phase_width, data_width, flavor)
    scale = jnp.float32(1.0 / (amp_in * (1 << (data_width - 2))))
    m2 = jnp.stack([mi, mq]).astype(jnp.float32) * scale  # (2, ..., T)
    # Causal circular alignment (matches the sharded variant): the tap
    # window *ends* at the output sample, the head wraps.  The main FIR
    # runs on the unpadded length-T stream (no T + halo concatenated copy
    # of the bulk input); the halo//decim wrapped outputs come from a tiny
    # separate segment.
    halo = len(h) - decim
    body = decimating_fir(m2, h, decim)  # y[m] for m >= halo//decim
    seg = jnp.concatenate([m2[..., t - halo:], m2[..., :halo]], axis=-1)
    wrap = decimating_fir(seg, h, decim)  # y[0 .. halo//decim)
    return jnp.concatenate([wrap, body], axis=-1)


def make_sharded_ddc(mesh: Mesh, phase_width: int, data_width: int,
                     freq: float, decim: int, taps=64,
                     cutoff: float | None = None, window: str = "bh4",
                     flavor: str = "scaled"):
    """Sharded DDC over the mesh 'blocks' axis.

    Input: global (T,) float stream sharded P('blocks').  Output:
    (2, T//decim) baseband I/Q sharded P(None, 'blocks').

    The halo runs on the RAW input stream (one ppermute of taps-decim
    f32 samples), *before* mixing: the NCO phase is closed-form per
    global index, so each shard simply mixes its extended chunk at the
    circularly wrapped indices — half the halo traffic of permuting the
    mixed (2, B) I/Q pair, and it matches :func:`ddc`'s circular
    alignment exactly (sharded == single-device to f32 accuracy; the
    integer mixing stage is bitwise when both sides use the same
    ``flavor``).

    ``flavor`` defaults to "scaled" here (vs :func:`ddc`'s "dds48"):
    XLA:CPU *execution* of the two-limb 48-bit dds48 graph with BOTH
    outputs alive is pathologically slow (~10 s per 8 samples inside
    shard_map; with x64 off, single-device jit too), which would wedge the
    CPU-mesh dryrun.  GPUs run it at full speed, sharded or not.  The scaled
    flavor is the reference's own area-optimized DDS
    (src/cordic_dds_scaled.vhd), shares the pre-rotation architecture and
    the -sin axis, and is single-int32-limb at every mixer-legal data
    width (SEL_SIZE(w <= 17) <= 24 bits).
    """
    from ..dist.halo import with_left_halo

    fw = freq_word(freq, phase_width)
    h = taps if hasattr(taps, "__len__") else design_lowpass(
        int(taps), (cutoff if cutoff is not None else 0.8 / decim),
        window=window)
    h = np.asarray(h)
    halo = len(h) - decim
    if halo < 0:
        raise ValueError("decimation larger than filter not supported")
    amp_in = float((1 << MIX_IN_BITS) - 1)
    scale = 1.0 / (amp_in * (1 << (data_width - 2)))
    nblocks = mesh.shape["blocks"]

    def shard_fn(x):  # (B,)
        b = x.shape[-1]
        if b % decim:
            raise ValueError("shard block must be a multiple of decim")
        t_total = b * nblocks
        i = jax.lax.axis_index("blocks")
        xh = with_left_halo(x, halo, "blocks", circular=True)
        # global indices of the extended chunk, wrapped circularly so the
        # NCO phase matches the single-device circular head extension
        n = i * b - halo + jnp.arange(b + halo, dtype=jnp.int32)
        n = jnp.where(n < 0, n + t_total, n)
        xq = jnp.round(jnp.asarray(xh, jnp.float32) * amp_in).astype(
            jnp.int32)
        mi, mq = mix_iq_int(xq, n, fw, phase_width, data_width, flavor)
        m = jnp.stack([mi, mq]).astype(jnp.float32) * jnp.float32(scale)
        return decimating_fir(m, h, decim)

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("blocks"),
        out_specs=P(None, "blocks"),
    )
