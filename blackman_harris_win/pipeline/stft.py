"""STFT analysis / WOLA synthesis — the invertible counterpart of Welch.

The reference's window cores front an FFT ("a user design (e.g. an FFT
front-end)", SURVEY.md §1 L3); the Welch analyzer (``pipeline/spectral.py``)
is the power-only consumer.  This module is the *invertible* one: short-time
Fourier transform plus weighted-overlap-add (WOLA) resynthesis, so a
modify-in-frequency chain (masking, filtering, channel equalization) can run
entirely on device around the reference's quantized windows.

Shape discipline (everything jit-clean, static shapes):

- Analysis frames reuse ``spectral.frames_view`` (shifted reshapes when
  hop | nfft — no gather).
- Overlap-add is the exact adjoint of that trick: each frame is split into
  ``r = nfft // hop`` hop-sized pieces and piece ``i`` of frame ``m`` lands at
  offset ``(m + i) * hop`` — r shifted, zero-padded adds; no scatter.  A
  ``.at[].add`` gather fallback covers hop ∤ nfft.
- WOLA normalization divides per sample by the tiled ``w_a * w_s`` sum
  instead of assuming COLA: the reference's ≥3-term Blackman-Harris windows
  are *not* constant-overlap-add at any standard hop
  (``windows/metrics.overlap_flatness``), so per-sample normalization is
  what makes round-trip reconstruction exact for every catalog window.

Perfect reconstruction (up to fp) holds for any window pair with a nowhere-
zero tiled product — in particular analysis == synthesis == any quantized
catalog window at hop ≤ nfft/2 (tests/test_stft.py).  Caveat: the first and
last ``nfft - hop`` samples see fewer frames, so where the window edge is
(near) zero — hann is exactly zero — their normalization is ill-conditioned;
treat them as warm-up/cool-down samples, as streaming WOLA filterbanks do.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import WindowSpec
from ..dist.halo import with_right_halo
from .spectral import frames_view, window_scale


def stft(x, win, nfft: int, hop: int):
    """Short-time Fourier transform of the last axis.

    x: (..., T) real; win: (nfft,) float.  Returns (..., nF, nfft//2+1)
    complex64 with frame m = rfft(x[m*hop : m*hop+nfft] * win); requires the
    exact tiling of ``frames_view`` ((T - nfft) % hop == 0).
    """
    return jnp.fft.rfft(frames_view(x, nfft, hop) * win, axis=-1)


def overlap_add(frames, hop: int, length: int | None = None):
    """Adjoint of ``frames_view``: sum frames (..., nF, nfft) into a signal
    (..., T) with frame m added at offset m*hop.  T defaults to the exact
    tiling length (nF-1)*hop + nfft.

    When hop | nfft this is r = nfft//hop shifted zero-padded adds (the
    reshape trick run backwards — XLA fuses it, no scatter); otherwise an
    ``.at[idx].add`` scatter.
    """
    nf, nfft = frames.shape[-2], frames.shape[-1]
    t = (nf - 1) * hop + nfft
    if length is None:
        length = t
    if length < t:
        raise ValueError(f"length {length} < overlap-add extent {t}")
    lead = frames.shape[:-2]
    if nfft % hop == 0:
        r = nfft // hop
        # piece i of frame m (frame[..., m, i*hop:(i+1)*hop]) lands at
        # sample offset (m+i)*hop; summing the r piece-streams shifted by
        # i*hop reproduces the overlap-add exactly.
        pieces = frames.reshape(lead + (nf, r, hop))
        nslot = length // hop + (1 if length % hop else 0)
        out = jnp.zeros(lead + (nslot, hop), frames.dtype)
        for i in range(r):
            p = pieces[..., :, i, :]  # (..., nF, hop), slot m+i
            pad = [(0, 0)] * len(lead) + [(i, nslot - nf - i), (0, 0)]
            out = out + jnp.pad(p, pad)
        return out.reshape(lead + (nslot * hop,))[..., :length]
    starts = jnp.arange(nf) * hop
    idx = starts[:, None] + jnp.arange(nfft)[None, :]
    out = jnp.zeros(lead + (length,), frames.dtype)
    return out.at[..., idx].add(frames)


def istft(s, win, hop: int, length: int | None = None, synthesis_win=None):
    """WOLA inverse STFT.  s: (..., nF, nfft//2+1) complex; ``win`` is the
    *analysis* window used by ``stft`` (synthesis window defaults to the
    same).  Per-sample normalization by the tiled w_a*w_s sum — exact
    reconstruction wherever that sum is nonzero (no COLA assumption; the
    catalog's ≥3-term windows are not COLA).  Returns (..., T) real.
    """
    nfft = 2 * (s.shape[-1] - 1)
    ws = win if synthesis_win is None else synthesis_win
    fr = jnp.fft.irfft(s, n=nfft, axis=-1) * ws
    nf = s.shape[-2]
    t = (nf - 1) * hop + nfft
    num = overlap_add(fr, hop, length)
    wprod = (jnp.asarray(win) * ws).astype(num.dtype)
    den = overlap_add(
        jnp.broadcast_to(wprod, (nf, nfft)), hop, length or t
    )
    eps = jnp.asarray(1e-12, num.dtype)
    return num / jnp.where(jnp.abs(den) < eps, eps, den)


def make_sharded_stft(
    mesh: Mesh,
    spec: WindowSpec,
    coeffs_q,
    shift: int,
    nfft: int,
    hop: int,
):
    """Build the sharded STFT analysis step (the invertible sibling of
    ``spectral.make_sharded_welch``).

    Input: global x of shape (C, T), sharded P('channels', 'blocks').
    Output: (C, T//hop, nfft//2+1) complex frames, sharded
    P('channels', 'blocks', None) — frame m stays resident on the shard
    that owns sample m*hop, so a modify-then-``istft`` stage needs no
    resharding.

    Framing is *periodic* (circular right halo of nfft-hop samples,
    ``dist.halo.with_right_halo``): every shard emits exactly B//hop frames,
    and the result equals the single-device
    ``stft(concat([x, x[:nfft-hop]]), ...)`` bit-for-bit
    (tests/test_stft.py::TestSharded).  The window is generated closed-form
    on every shard — no table, no broadcast (README.md:2-3).
    """
    from ..kernels.window import window_samples

    coeffs_q = tuple(int(c) for c in coeffs_q)
    halo = nfft - hop
    scale = window_scale(spec, shift)

    def shard_fn(x):  # x: (C_local, B)
        b = x.shape[-1]
        if b % hop:
            raise ValueError(f"shard block {b} must be a multiple of hop {hop}")
        wq = window_samples(jnp.arange(nfft, dtype=jnp.int32), coeffs_q, spec)
        win = wq.astype(jnp.float32) * jnp.float32(scale)
        xh = with_right_halo(x, halo, "blocks", circular=True)
        return stft(xh, win, nfft, hop)  # (C_local, B//hop, nfft//2+1)

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("channels", "blocks"),
        out_specs=P("channels", "blocks", None),
    )


def make_sharded_istft(
    mesh: Mesh,
    spec: WindowSpec,
    coeffs_q,
    shift: int,
    nfft: int,
    hop: int,
    synthesis: bool = True,
):
    """Build the sharded WOLA inverse of ``make_sharded_stft``.

    Input: global frames (C, T//hop, nfft//2+1), sharded
    P('channels', 'blocks', None) — exactly what ``make_sharded_stft``
    leaves resident.  Output: (C, T) samples sharded P('channels', 'blocks').

    Communication is one circular ``ppermute``: each shard overlap-adds its
    local frames into a block+tail buffer and ships the nfft-hop tail to its
    right neighbor's head (the exact adjoint of the analysis halo).  Because
    the circular framing covers *every* sample with the full nfft/hop
    overlap, the WOLA denominator is the closed-form hop-periodic vector
    ``sum_i (w_a*w_s)[i*hop + (t mod hop)]`` — computed locally on every
    shard, no edge conditioning anywhere: sharded istft∘stft is an exact
    inverse at all T samples (tests/test_stft.py::TestSharded).

    ``synthesis=False`` divides by the analysis window's tiling alone
    (synthesis window = 1).
    """
    from jax import lax

    from ..kernels.window import window_samples

    coeffs_q = tuple(int(c) for c in coeffs_q)
    halo = nfft - hop
    scale = window_scale(spec, shift)
    if nfft % hop:
        raise ValueError(
            f"sharded WOLA needs hop | nfft (got {hop}, {nfft}): the "
            "closed-form periodic denominator requires uniform coverage"
        )

    def shard_fn(s):  # s: (C_local, nF_local, nfft//2+1)
        wq = window_samples(jnp.arange(nfft, dtype=jnp.int32), coeffs_q, spec)
        win = wq.astype(jnp.float32) * jnp.float32(scale)
        ws = win if synthesis else jnp.ones_like(win)
        fr = jnp.fft.irfft(s, n=nfft, axis=-1).astype(jnp.float32) * ws
        ola = overlap_add(fr, hop)  # (C_local, B + halo)
        b = fr.shape[-2] * hop
        body, tail = ola[..., :b], ola[..., b:]
        n = lax.axis_size("blocks")
        recv = lax.ppermute(  # my tail -> right neighbor's head (circular)
            tail, "blocks", [(i, (i + 1) % n) for i in range(n)]
        )
        y = body.at[..., :halo].add(recv)
        den = (win * ws).reshape(nfft // hop, hop).sum(axis=0)  # (hop,)
        eps = jnp.float32(1e-12)  # hop == nfft with a zero-edge window
        den = jnp.where(jnp.abs(den) < eps, eps, den)
        return y / jnp.tile(den, b // hop)

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("channels", "blocks", None),
        out_specs=P("channels", "blocks"),
    )


def quantized_stft_pair(name: str, spec: WindowSpec, hop: int | None = None):
    """(stft_fn, istft_fn, win) closure pair for one catalog window at the
    reference quantization (``catalog.golden_quantized_window`` rule run on
    device via ``kernels.window.window_samples``).  nfft = spec.n."""
    from ..kernels.window import window_samples
    from ..windows import catalog

    nfft = spec.n
    hop = hop or nfft // 2
    d = catalog.get(name)
    wq = window_samples(
        jnp.arange(nfft, dtype=jnp.int32), d.quantized(spec.data_width), spec
    )
    win = wq.astype(jnp.float32) * jnp.float32(window_scale(spec, d.shift))

    def fwd(x):
        return stft(x, win, nfft, hop)

    def inv(s, length=None):
        return istft(s, win, hop, length)

    return fwd, inv, win


def float_stft_pair(name: str, pw: int, hop: int | None = None):
    """(stft_fn, istft_fn, win) pair over the native float32 window
    (``kernels/floatwin.py`` — no int datapath, no convert pass; same
    floors through 5-term windows, BH-7 ~ -163 dB).  nfft = 2^pw."""
    from ..kernels.floatwin import float_window

    nfft = 1 << pw
    hop = hop or nfft // 2
    win = float_window(name, pw)

    def fwd(x):
        return stft(x, win, nfft, hop)

    def inv(s, length=None):
        return istft(s, win, hop, length)

    return fwd, inv, win


def comp_stft_pair(name: str, pw: int, hop: int | None = None):
    """(stft_fn, istft_fn, (whi, wlo)) pair over the compensated-f32
    window pair (``kernels/compwin.py``): analysis frames are windowed as
    ``fr*whi + fr*wlo`` so the applied window carries the full f64 floor
    (BH-7 −180.4 dB — plain f32 holds −163).  The WOLA inverse normalizes
    by the tiled (whi+wlo)^2 sum.  nfft = 2^pw."""
    from ..kernels.compwin import comp_window_pair

    nfft = 1 << pw
    hop = hop or nfft // 2
    whi, wlo = comp_window_pair(name, pw)

    def fwd(x):
        fr = frames_view(x, nfft, hop)
        return jnp.fft.rfft(fr * whi + fr * wlo, axis=-1)

    def inv(s, length=None):
        fr = jnp.fft.irfft(s, n=nfft, axis=-1)
        fr = fr * whi + fr * wlo
        nf = s.shape[-2]
        t = (nf - 1) * hop + nfft
        num = overlap_add(fr, hop, length)
        w1 = whi.astype(num.dtype) + wlo.astype(num.dtype)
        den = overlap_add(
            jnp.broadcast_to(w1 * w1, (nf, nfft)), hop, length or t
        )
        eps = jnp.asarray(1e-12, num.dtype)
        return num / jnp.where(jnp.abs(den) < eps, eps, den)

    return fwd, inv, (whi, wlo)
