"""Windowed overlap-save FFT spectral analyzer (Welch power spectrum).

This is the downstream consumer the reference's window cores were built for
(the win_selector front-end feeds "a user design (e.g. an FFT front-end)",
SURVEY.md §1 L3).  The pipeline:

  sample stream -> overlapped frames -> on-the-fly quantized window apply
  -> rFFT -> |.|^2 -> Welch average

Sharded variant: the time axis shards over the mesh 'blocks' axis; frames
straddling shard boundaries read the right neighbor's head via a ppermute
halo (``dist.halo``); the Welch average is a psum over shards.  Channels
shard over the 'channels' axis with no communication.  Window coefficients
are generated closed-form on every shard (cheap, communication-free) — no
window table is ever stored (the reference's defining feature, README.md:2-3).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import WindowSpec
from ..dist.halo import with_right_halo
from ..kernels.window import window_samples


def window_scale(spec: WindowSpec, shift: int) -> float:
    """Float scale of the quantized window: values are round(w * (2^(W-shift)-1))."""
    return 1.0 / (2.0 ** (spec.data_width - shift) - 1.0)


def _check_float_window_arg(name_or_coeffs):
    """Guard the ``win_mode="float"`` argument: it must be a catalog name or
    a *float* coefficient tuple (|a_k| <= 1).  A caller that flips the mode
    flag while still passing the usual quantized-integer tuple would
    otherwise get a silently wrong window with integer-count amplitudes."""
    if isinstance(name_or_coeffs, str):
        return name_or_coeffs
    coeffs = tuple(float(c) for c in name_or_coeffs)
    if not coeffs or max(abs(c) for c in coeffs) > 1.0:
        raise ValueError(
            "win_mode='float' takes a window name or float coefficients "
            f"with |a_k| <= 1, got {name_or_coeffs!r} (looks like a "
            "quantized integer set — use win_mode='quantized' for those)"
        )
    return coeffs


def frames_view(x, nfft: int, hop: int):
    """Overlapped frames of the last axis: (..., T) -> (..., nF, nfft) with
    frame m = x[..., m*hop : m*hop+nfft]; requires T >= nfft and exact tiling
    ((T - nfft) % hop == 0).

    When hop divides nfft the frames are assembled from r = nfft/hop shifted
    reshapes (pure slicing — XLA fuses it; no gather materialization);
    otherwise falls back to an index gather.
    """
    t = x.shape[-1]
    nf = (t - nfft) // hop + 1
    if nfft % hop == 0 and t % hop == 0:
        r = nfft // hop
        xr = x.reshape(x.shape[:-1] + (t // hop, hop))
        parts = [xr[..., i : nf + i, :] for i in range(r)]
        return jnp.concatenate(parts, axis=-1)
    starts = jnp.arange(nf) * hop
    idx = starts[:, None] + jnp.arange(nfft)[None, :]
    return x[..., idx]


def welch_power(x, win, nfft: int, hop: int, fft_mode: str = "rfft"):
    """Single-device Welch periodogram: mean |rfft(frame * win)|^2 over
    frames.  x: (..., T) float; win: (nfft,) float.

    ``fft_mode="packed"`` runs the classic two-real-frames-per-complex-FFT
    packing instead of per-frame rFFTs: adjacent frame pairs become one
    complex64 frame z = f_even + j f_odd, one CFFT per pair, and the two
    real spectra come back out of conjugate symmetry
    (F_even(k) = (Z(k) + Z*(-k))/2, F_odd(k) = (Z(k) - Z*(-k))/(2j)) —
    identical math in exact arithmetic, half as many FFTs when XLA's rFFT
    does not itself exploit real symmetry.  Only the *summed power* is
    needed, so the unpack simplifies further: |F_even|^2 + |F_odd|^2
    = (|Z(k)|^2 + |Z(-k)|^2) / 2 — no complex unpack arithmetic at all,
    just the power spectrum of Z read forwards and backwards.
    """
    fr = frames_view(x, nfft, hop) * win
    return frame_mean_power(fr, fft_mode)


def frame_mean_power(fr, fft_mode: str = "rfft"):
    """Mean half-spectrum power over windowed frames (..., nF, nfft) ->
    (..., nfft//2+1); the FFT stage shared by every welch/comp path.

    ``fft_mode="mxu"`` bypasses XLA's FFT entirely: packed complex frame
    pairs go through mixed-radix Cooley-Tukey stages whose small DFTs are
    dense **matmuls** (radices <= 128, f64-host-exact twiddle tables,
    ``Precision.HIGHEST`` so float32 products are never demoted to TF32).
    Requires power-of-two nfft >= 256.
    """
    if fft_mode == "rfft":
        spec = jnp.fft.rfft(fr, axis=-1)
        return jnp.mean(jnp.abs(spec) ** 2, axis=-2)
    if fft_mode == "mxu":
        return _mxu_packed_mean_power(fr)
    if fft_mode != "packed":
        raise ValueError("fft_mode must be 'rfft', 'packed' or 'mxu'")
    nfft = fr.shape[-1]
    nf = fr.shape[-2]
    if nf % 2:  # pad one zero frame; it adds nothing to the power sum
        pad = [(0, 0)] * (fr.ndim - 2) + [(0, 1), (0, 0)]
        fr = jnp.pad(fr, pad)
    z = jax.lax.complex(fr[..., 0::2, :], fr[..., 1::2, :])
    zf = jnp.fft.fft(z, axis=-1)
    p = jnp.abs(zf) ** 2  # (..., nF/2, nfft)
    k = nfft // 2 + 1
    # |Z(-k)|^2 for k = 0..nfft/2 is p reversed with the k=0 bin fixed
    p_rev = jnp.concatenate(
        [p[..., :1], jnp.flip(p[..., 1:], axis=-1)], axis=-1
    )
    ps = 0.5 * (p[..., :k] + p_rev[..., :k])
    return jnp.sum(ps, axis=-2) / nf


def _mxu_radices(nfft: int) -> tuple[int, ...]:
    """Factor a power-of-two nfft into matmul DFT radices: the fewest
    stages with every radix <= 128, split as evenly as possible (1M ->
    (128, 128, 64))."""
    if nfft < 256 or nfft & (nfft - 1):
        raise ValueError(
            "fft_mode='mxu' needs a power-of-two nfft >= 256 "
            f"(got {nfft}); use 'rfft' or 'packed'"
        )
    k = nfft.bit_length() - 1
    s = -(-k // 7)  # ceil: minimum stages with radix <= 2^7
    base, extra = divmod(k, s)
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(s))


def _dft_tables(nfft: int):
    """Host-f64-exact DFT matrices and inter-stage twiddles for
    :func:`_mxu_radices`, as (real, imag) f32 numpy pairs."""
    radices = _mxu_radices(nfft)
    mats, tws = [], []
    for s_i, r in enumerate(radices):
        k = np.arange(r)
        ang = -2.0 * np.pi * (k[:, None] * k[None, :] % r) / r
        mats.append((np.cos(ang).astype(np.float32),
                     np.sin(ang).astype(np.float32)))
        if s_i < len(radices) - 1:
            nt = 1
            for rr in radices[s_i:]:
                nt *= rr
            rest = nt // r
            if r * rest > (1 << 22):
                # a host table this size would be embedded in the
                # program as a constant (tens of MB and up); build it
                # on device instead (_mxu_stages).  i*j < nt <= 2^31 so
                # the int32 product is exact; the f32 angle carries the
                # index at ~2 ulp -> twiddle error ~4e-7, fine for power
                # spectra.
                tws.append(nt)
            else:
                ii, jj = np.arange(r), np.arange(rest)
                ang = -2.0 * np.pi * (ii[:, None] * jj[None, :] % nt) / nt
                tws.append((np.cos(ang).astype(np.float32),
                            np.sin(ang).astype(np.float32)))
    return radices, mats, tws


def _mxu_stages(xr, xi, nfft: int, nlead: int):
    """Run the mixed-radix matmul DFT stages over the trailing radix axes
    of (lead..., r_0, .., r_{ns-1}) real/imag arrays.  On return, axis
    nlead+i indexes output digit k_i with bin k = k_0 + r_0*k_1 + ...

    Transpose-free formulation: tensordot appends the contracted-output
    axis, so stage s always contracts the FIRST remaining sample axis
    (position ``nlead``) and the k axes accumulate at the tail in stage
    order — no inter-stage data transposes (the naive
    restore-axis-position version spent ~2 big c64 transposes per
    transform).  Twiddles broadcast as (rest..., 1*s, r_s) to match the
    shifted layout."""
    radices, mats_np, tws_np = _dft_tables(nfft)
    mats = [tuple(jnp.asarray(v) for v in m) for m in mats_np]
    hi = lax.Precision.HIGHEST

    ns = len(radices)
    for s_i, r in enumerate(radices):
        mr, mi = mats[s_i]
        # axes: (lead..., n_{s}, .., n_{ns-1}, k_0, .., k_{s-1});
        # contract n_s at position nlead, its k_s lands at the end
        yr = (jnp.tensordot(xr, mr, axes=[[nlead], [1]], precision=hi)
              - jnp.tensordot(xi, mi, axes=[[nlead], [1]], precision=hi))
        yi = (jnp.tensordot(xr, mi, axes=[[nlead], [1]], precision=hi)
              + jnp.tensordot(xi, mr, axes=[[nlead], [1]], precision=hi))
        xr, xi = yr, yi
        if s_i < ns - 1:
            rest_dims = tuple(radices[s_i + 1:])
            rest = 1
            for rr in rest_dims:
                rest *= rr
            tw = tws_np[s_i]
            if isinstance(tw, int):  # big table: build on device (iota)
                nt = tw
                ii = lax.broadcasted_iota(jnp.int32, (r, rest), 0)
                jj = lax.broadcasted_iota(jnp.int32, (r, rest), 1)
                ang = (ii * jj).astype(jnp.float32) * jnp.float32(
                    -2.0 * np.pi / nt)
                twr, twi = jnp.cos(ang), jnp.sin(ang)
            else:
                twr, twi = (jnp.asarray(v) for v in tw)
            # table is (k_s, rest); the array layout here is
            # (lead, rest_dims..., k_0..k_{s-1}, k_s) -> broadcast the
            # TRANSPOSED table as (1..., rest_dims..., 1*s, r)
            shape = (1,) * nlead + rest_dims + (1,) * s_i + (r,)
            twr = twr.T.reshape(shape)
            twi = twi.T.reshape(shape)
            xr, xi = (xr * twr - xi * twi, xr * twi + xi * twr)
    # axes now (lead..., k_0, .., k_{ns-1}) — same contract as before
    return xr, xi, radices


def mxu_cfft(zr, zi):
    """Complex FFT over the last axis through matmul DFT stages,
    natural bin order: (..., M) real/imag f32 -> (..., M) real/imag f32.
    M must satisfy :func:`_mxu_radices` (power of two >= 256)."""
    m = zr.shape[-1]
    radices = _mxu_radices(m)
    lead = zr.shape[:-1]
    nl = len(lead)
    xr = zr.reshape(lead + radices)
    xi = zi.reshape(lead + radices)
    xr, xi, _ = _mxu_stages(xr, xi, m, nl)
    ns = len(radices)
    perm = tuple(range(nl)) + tuple(nl + i for i in reversed(range(ns)))
    return (jnp.transpose(xr, perm).reshape(lead + (m,)),
            jnp.transpose(xi, perm).reshape(lead + (m,)))


def _mxu_packed_mean_power(fr):
    """The fft_mode="mxu" body: two real frames per complex input, matmul
    DFT stages, power-only unpack via conjugate symmetry."""
    nfft = fr.shape[-1]
    nf = fr.shape[-2]
    radices = _mxu_radices(nfft)

    if nf % 2:
        pad = [(0, 0)] * (fr.ndim - 2) + [(0, 1), (0, 0)]
        fr = jnp.pad(fr, pad)
    lead = fr.shape[:-2]
    npair = fr.shape[-2] // 2
    xr = fr[..., 0::2, :].reshape(lead + (npair,) + radices)
    xi = fr[..., 1::2, :].reshape(lead + (npair,) + radices)
    nlead = len(lead) + 1

    xr, xi, radices = _mxu_stages(xr, xi, nfft, nlead)
    ns = len(radices)

    p = jnp.sum(xr * xr + xi * xi, axis=nlead - 1)  # sum over frame pairs
    # axes now lead + (k_0, .., k_{ns-1}) with bin k = k_0 + r_0*k_1 + ..:
    # natural bin order = transpose to reversed radix axes, flatten
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + i for i in reversed(range(ns)))
    pk = jnp.transpose(p, perm).reshape(lead + (nfft,))
    k = nfft // 2 + 1
    pk_rev = jnp.concatenate(
        [pk[..., :1], jnp.flip(pk[..., 1:], axis=-1)], axis=-1
    )
    ps = 0.5 * (pk[..., :k] + pk_rev[..., :k])
    return ps / nf


def rfft_power_split(x, fft_mode: str = "rfft"):
    """``|rfft(x)|**2`` computed through ONE half-length complex FFT.

    The classic even/odd split: z[m] = x[2m] + j x[2m+1] (length N/2),
    Z = fft(z); then with E(k) = (Z(k) + Z*(-k))/2 and
    O(k) = (Z(k) - Z*(-k))/(2j), the real spectrum is
    X(k) = E(k) + e^{-2 pi j k / N} O(k) for k = 0..N/2 (Nyquist bin:
    E(0) - O(0)).  Useful when the backend's rfft does not itself exploit
    real symmetry — the FFT work halves and the unpack is O(N)
    elementwise.  f32 twiddles: bin error ~2e-7 relative (the angle
    pi*k/(N/2) carries k/(N/2) at f32 precision), comparable to the f32
    FFT's own rounding — fine for power spectra, not for phase-critical
    use.  x: (..., N) float32, N even; returns (..., N//2+1) f32.

    ``fft_mode``: backend for the half-length CFFT — "rfft" (misnomer
    here: XLA's plain cfft) or "mxu" (the matmul DFT stages).
    """
    n = x.shape[-1]
    if n % 2:
        raise ValueError("rfft_power_split needs an even length")
    m = n // 2
    if fft_mode == "mxu":
        zfr, zfi = mxu_cfft(x[..., 0::2], x[..., 1::2])
        zf = jax.lax.complex(zfr, zfi)
    else:
        z = jax.lax.complex(x[..., 0::2], x[..., 1::2])
        zf = jnp.fft.fft(z, axis=-1)
    zrc = jnp.conj(jnp.concatenate(
        [zf[..., :1], jnp.flip(zf[..., 1:], axis=-1)], axis=-1))  # Z*(-k)
    e = 0.5 * (zf + zrc)
    o = -0.5j * (zf - zrc)
    ang = jnp.float32(np.pi) * (
        jnp.arange(m, dtype=jnp.float32) / jnp.float32(m))
    tw = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))
    p = jnp.abs(e + tw * o) ** 2  # k = 0..m-1
    pny = jnp.abs(e[..., :1] - o[..., :1]) ** 2  # Nyquist bin
    return jnp.concatenate([p, pny], axis=-1)


def windowed_power_spectrum(x, name_or_coeffs, spec: WindowSpec, hop=None,
                            win_mode: str = "quantized",
                            fft_mode: str = "rfft"):
    """Convenience single-chip analyzer: window generated on the fly,
    applied, Welch-averaged.  nfft = spec.n.

    ``win_mode="quantized"`` (default) reproduces the reference's integer
    window datapath, then scales to float for the FFT.
    ``win_mode="float"`` generates the window natively in float32
    (``kernels/floatwin.py`` — ~4 f32 ops/harmonic/sample, no int->float
    convert pass); same floors through 5-term windows, BH-7 holds
    ~ -163 dB instead of -180 (measured, tests/test_floatwin.py).
    """
    from ..windows import catalog

    nfft = spec.n
    hop = hop or nfft // 2
    if win_mode == "float":
        from ..kernels.floatwin import float_window

        win = float_window(_check_float_window_arg(name_or_coeffs),
                           spec.phase_width)
        return welch_power(x, win, nfft, hop, fft_mode)
    if win_mode == "comp":
        # compensated-f32 raw pair applied as two FMAs per sample: the
        # frames see the window at ~2^-31 accuracy (kernels/compwin.py)
        from ..kernels.compwin import comp_window_pair

        whi, wlo = comp_window_pair(_check_float_window_arg(name_or_coeffs),
                                    spec.phase_width)
        fr = frames_view(x, nfft, hop)
        return frame_mean_power(fr * whi + fr * wlo, fft_mode)
    if win_mode != "quantized":
        raise ValueError("win_mode must be 'quantized', 'float' or 'comp'")
    if isinstance(name_or_coeffs, str):
        d = catalog.get(name_or_coeffs)
        coeffs_q, shift = d.quantized(spec.data_width), d.shift
    else:
        coeffs_q, shift = tuple(name_or_coeffs), 1
    wq = window_samples(jnp.arange(nfft), coeffs_q, spec)
    win = wq.astype(jnp.float32) * window_scale(spec, shift)
    return welch_power(x, win, nfft, hop, fft_mode)


def make_sharded_welch(
    mesh: Mesh,
    spec: WindowSpec,
    coeffs_q,
    shift: int,
    nfft: int,
    hop: int,
    win_mode: str = "quantized",
    fft_mode: str = "rfft",
):
    """Build the sharded analyzer step.

    Input: global x of shape (C, T), sharded P('channels', 'blocks').
    Output: (C, nfft//2+1) Welch spectrum, sharded P('channels') and
    replicated over 'blocks'.

    Per shard: generate the window locally (no comm), frame its time chunk
    with a circular right halo of nfft-hop samples (ppermute), FFT, and
    pmean the power over the 'blocks' axis (psum collective).

    ``win_mode="float"`` generates the window natively in float32 on every
    shard (``kernels/floatwin.py`` — ``coeffs_q``/``shift`` are then
    ignored and the *float* catalog coefficients are used via
    ``spec``-independent tables; pass the window name in ``coeffs_q``).
    ``win_mode="comp"`` uses the compensated-f32 pair
    (``kernels/compwin.py``): frames are windowed as fr*hi + fr*lo, so
    the applied window holds the full −180 dB BH-7 floor.
    """
    halo = nfft - hop

    if win_mode in ("float", "comp"):
        if nfft != spec.n:
            raise ValueError(f"{win_mode} win_mode needs nfft == 2^phase_width")
        name_or_coeffs = _check_float_window_arg(coeffs_q)

        if win_mode == "float":
            def make_win():
                from ..kernels.floatwin import float_window

                return float_window(name_or_coeffs, spec.phase_width)
        else:
            def make_win():
                from ..kernels.compwin import comp_window_pair

                return comp_window_pair(name_or_coeffs, spec.phase_width)
    elif win_mode == "quantized":
        coeffs_q = tuple(int(c) for c in coeffs_q)
        scale = window_scale(spec, shift)

        def make_win():
            wq = window_samples(
                jnp.arange(nfft, dtype=jnp.int32), coeffs_q, spec
            )
            return wq.astype(jnp.float32) * jnp.float32(scale)
    else:
        raise ValueError("win_mode must be 'quantized', 'float' or 'comp'")

    def shard_fn(x):  # x: (C_local, B)
        b = x.shape[-1]
        if b % hop:
            raise ValueError(f"shard block {b} must be a multiple of hop {hop}")
        win = make_win()
        xh = with_right_halo(x, halo, "blocks", circular=True)
        if isinstance(win, tuple):  # compensated (hi, lo) pair
            whi, wlo = win
            fr = frames_view(xh, nfft, hop)
            p = frame_mean_power(fr * whi + fr * wlo, fft_mode)
        else:
            p = welch_power(xh, win, nfft, hop, fft_mode)  # this shard's frames
        return lax.pmean(p, "blocks")

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("channels", "blocks"),
        out_specs=P("channels", None),
    )
