"""Smoke run of the library's main path on one NVIDIA GPU.

    python chip_smoke.py                  # every phase, one card
    python chip_smoke.py --phase welch    # one phase, for debugging
    python chip_smoke.py --chips 4        # only the sharded phases, 4 cards

Each phase calls a public entry point at the size its users run, on data
made from ``--seed``, and checks the result against an independent
reference: the integer paths to 0 LSB against the C++ golden oracle
(``native/golden.cpp``), the float paths against float64 NumPy within a
tolerance stated beside the check with its reason.  Every phase prints, on
its own line, compile seconds, steady seconds (host clock around
``block_until_ready``), Msamp/s and the process's peak device memory so
far.  A failed check ends the run with a non-zero exit.

The run is one process with x64 off (the production regime).  It refuses
to start unless JAX's first device is a GPU.  Its last line is exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import shutil
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

#: float32 unit roundoff
EPS32 = 2.0**-24


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase (``FULL`` on the card, ``TINY`` in the
    CPU tests)."""

    gen_pw: int  # the reference's 64M-point window (2^26)
    full_period_pw: int  # HLS window checked over its whole period
    taylor_pw: int
    check_blocks: int  # random blocks checked against the oracle ...
    check_block: int  # ... of this many samples, plus the quadrant seams
    welch_pw: int  # one channel x welch_frames frames of 2^welch_pw
    welch_frames: int
    mc_channels: int  # multi-channel Welch: channels x mc_samples
    mc_samples: int
    mc_pw: int
    stft_samples: int
    sdr_samples: int
    sdr_segment: int  # channelizer checked against float64 on this prefix
    ddc_samples: int
    ddc_segment: int  # baseband outputs checked against float64
    cli_samples: int
    cli_pw: int
    scan_pw: int  # gen -> sum through lax.scan, as bench.py runs it
    scan_block: int
    reps: int  # timed repetitions per step
    # --chips 4
    sh_welch_channels: int
    sh_welch_samples: int
    sh_welch_pw: int
    sh_stft_channels: int
    sh_stft_samples: int
    sh_stft_pw: int
    sh_sdr_samples: int
    sh_ddc_samples: int
    # NCO flavors of the DDC phases.  XLA:CPU executes the x64-off dds48
    # graph (two int32 limbs, both outputs alive) pathologically slowly,
    # so the CPU tests run the scaled flavor only.
    ddc_flavors: tuple = ("dds48", "scaled")


FULL = Sizes(
    gen_pw=26, full_period_pw=20, taylor_pw=20, check_blocks=64,
    check_block=4096, welch_pw=20, welch_frames=128, mc_channels=16,
    mc_samples=1 << 22, mc_pw=16, stft_samples=1 << 24,
    sdr_samples=1 << 26, sdr_segment=1 << 20, ddc_samples=1 << 26,
    ddc_segment=4096, cli_samples=1 << 24, cli_pw=20, scan_pw=26,
    scan_block=1 << 22, reps=3,
    sh_welch_channels=16, sh_welch_samples=1 << 24, sh_welch_pw=16,
    sh_stft_channels=16, sh_stft_samples=1 << 20, sh_stft_pw=12,
    sh_sdr_samples=1 << 26, sh_ddc_samples=1 << 26,
)

TINY = Sizes(
    gen_pw=12, full_period_pw=10, taylor_pw=12, check_blocks=4,
    check_block=64, welch_pw=10, welch_frames=8, mc_channels=2,
    mc_samples=1 << 12, mc_pw=8, stft_samples=1 << 14,
    sdr_samples=1 << 14, sdr_segment=1 << 12, ddc_samples=1 << 14,
    ddc_segment=256, cli_samples=1 << 13, cli_pw=10, scan_pw=16,
    scan_block=1 << 14, reps=1,
    sh_welch_channels=4, sh_welch_samples=1 << 12, sh_welch_pw=8,
    sh_stft_channels=4, sh_stft_samples=1 << 13, sh_stft_pw=8,
    sh_sdr_samples=1 << 14, sh_ddc_samples=1 << 14,
    ddc_flavors=("scaled",),
)


class CheckFailed(AssertionError):
    """A phase's result disagrees with its reference."""


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


class Run:
    """Per-phase timing and report lines (printed as they happen)."""

    def __init__(self, sizes: Sizes, seed: int, workdir: pathlib.Path,
                 emit=print):
        self.sizes = sizes
        self.seed = seed
        self.workdir = workdir
        self.emit = emit
        self.phase = ""

    def rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, salt])

    def note(self, **fields) -> None:
        self.emit("finding " + json.dumps({"phase": self.phase, **fields}))

    def timed(self, step: str, fn, *args, samples: int, jit: bool = True,
              memory_analysis: bool = False):
        """Compile ``fn`` (timed on its own), run it once for the result,
        then time ``reps`` further calls, each ended by block_until_ready.
        Returns (result, steady seconds)."""
        import jax

        from blackman_harris_win.utils.profiling import steady_seconds

        t0 = time.perf_counter()
        if jit:
            compiled = jax.jit(fn).lower(*args).compile()
        else:
            compiled = fn
        compile_s = time.perf_counter() - t0
        if memory_analysis:
            ma = compiled.memory_analysis()
            self.emit("memory_analysis " + json.dumps({
                "phase": self.phase, "step": step,
                **{k: getattr(ma, k) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "alias_size_in_bytes",
                    "generated_code_size_in_bytes") if hasattr(ma, k)},
            }))
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        first_s = time.perf_counter() - t0
        steady = steady_seconds(compiled, *args, reps=self.sizes.reps)
        stats = jax.devices()[0].memory_stats() or {}
        self.emit("timing " + json.dumps({
            "phase": self.phase, "step": step,
            "compile_s": compile_s if jit else None,
            "first_call_s": first_s,
            "steady_s": steady,
            "msamp_s": samples / steady / 1e6,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        }))
        return out, steady


# ---------------------------------------------------------------------------
# references and index sets
# ---------------------------------------------------------------------------

def check_indices(run: Run, n: int, salt: int) -> np.ndarray:
    """Random blocks of the period plus the blocks around its quadrant
    seams (every datapath bug so far surfaced at a seam)."""
    s = run.sizes
    b = min(s.check_block, n)
    starts = list(run.rng(salt).integers(0, n - b + 1, s.check_blocks))
    starts += [(q * n // 4 - b // 2) % n for q in range(4)]
    return np.unique(np.concatenate(
        [(st + np.arange(b)) % n for st in starts]))


def welch_ref(x, win, nfft: int, hop: int) -> np.ndarray:
    """float64 Welch: mean |rfft(frame * win)|^2 over the frames of the last
    axis, frame by frame."""
    x = np.asarray(x)
    win = np.asarray(win, np.float64)
    nf = (x.shape[-1] - nfft) // hop + 1
    acc = np.zeros(x.shape[:-1] + (nfft // 2 + 1,))
    for m in range(nf):
        fr = x[..., m * hop: m * hop + nfft].astype(np.float64) * win
        acc += np.abs(np.fft.rfft(fr, axis=-1)) ** 2
    return acc / nf


def welch_budget(nfft: int) -> float:
    """Relative bin error budget of an f32 Welch against float64: ~nfft f32
    operations reach each bin, eps 2^-24, incoherent growth sqrt(nfft), x32
    for FFT constant factors and the window's f32 rounding."""
    return 32 * EPS32 * math.sqrt(nfft)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-300)))


def quantized_window_f64(name: str, pw: int, w: int) -> np.ndarray:
    """The HLS-contract quantized window from the C++ oracle, scaled to
    float exactly as ``pipeline.spectral.window_scale`` does."""
    from blackman_harris_win.model import native
    from blackman_harris_win.windows import catalog

    d = catalog.get(name)
    wq = native.win_hls(np.arange(1 << pw), d.quantized(w), pw, w)
    return wq.astype(np.float64) / (2.0 ** (w - d.shift) - 1.0)


def taylor_window_ref(idx, coeffs_q, pw: int, w: int, ls: int) -> np.ndarray:
    """TAYLOR-source HLS window from the C++ Taylor oracle: harmonic k runs
    the generator k-1 phase bits narrower (src/bh_win_3term.vhd:221-233),
    products shift by W-1 (full-scale source), win_t wrap."""
    from blackman_harris_win.model import native

    idx = np.asarray(idx, np.int64)
    acc = np.full(idx.shape, int(coeffs_q[0]), np.int64)
    for k in range(1, len(coeffs_q)):
        pwk = pw - (k - 1)
        c, _ = native.taylor_sincos(idx & ((1 << pwk) - 1), pwk, w, ls)
        m = (int(coeffs_q[k]) * c) >> (w - 1)
        acc = acc - m if k % 2 == 1 else acc + m
    return (acc << (64 - w)) >> (64 - w)


def channelize_ref(x, h, c: int) -> np.ndarray:
    """float64 critically sampled polyphase DFT bank (the formula of
    ``pipeline/channelizer.py``): y_p[j] = sum_t h[tC+p] x[(j+tpb-1-t)C+p],
    then an FFT across branches."""
    h = np.asarray(h, np.float64)
    tpb = h.size // c
    xp = np.asarray(x, np.float64).reshape(-1, c)
    hp = h.reshape(tpb, c)
    nout = xp.shape[0] - (tpb - 1)
    y = np.zeros((nout, c))
    for t in range(tpb):
        y += hp[t] * xp[tpb - 1 - t: tpb - 1 - t + nout]
    return np.fft.fft(y, axis=-1)


def tone(run: Run, n: int, freq: float, salt: int) -> np.ndarray:
    """cos(2 pi freq n) plus -40 dB Gaussian noise, float32."""
    nn = np.arange(n, dtype=np.float64)
    x = np.cos(2.0 * np.pi * freq * nn)
    x += 0.01 * run.rng(salt).standard_normal(n)
    return x.astype(np.float32)


def baseband_freq(bb, decim: int) -> float:
    """Mean instantaneous frequency (cycles per input sample) of a (2, M)
    I/Q baseband."""
    i = np.asarray(bb[0], np.float64)
    q = np.asarray(bb[1], np.float64)
    ph = np.unwrap(np.arctan2(q, i))[8:-8]
    return float(np.mean(np.diff(ph)) / (2 * np.pi * decim))


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_gen_hls(run: Run) -> None:
    """Bit-exact HLS contract, BH-7 W=32 (-180 dB), materialized."""
    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import make_window
    from blackman_harris_win.model import native
    from blackman_harris_win.windows import catalog

    pw, w = run.sizes.gen_pw, 32
    q = catalog.get("bh7").quantized(w)
    spec = WindowSpec(pw, w, overflow="wrap")
    win, _ = run.timed("make_window", functools.partial(
        make_window, "bh7", spec), samples=spec.n, memory_analysis=True)
    check(win.shape == (spec.n,), f"shape {win.shape}")
    idx = check_indices(run, spec.n, 1)
    got = np.asarray(win)[idx].astype(np.int64)
    want = native.win_hls(idx, q, pw, w)
    bad = np.flatnonzero(got != want)
    check(bad.size == 0, f"gen-hls: {bad.size} of {idx.size} samples differ "
          f"from the oracle, first n={idx[bad[:1]]}")
    del win

    pf = run.sizes.full_period_pw
    spec_f = WindowSpec(pf, w, overflow="wrap")
    full, _ = run.timed("make_window_full_period", functools.partial(
        make_window, "bh7", spec_f), samples=spec_f.n)
    want = native.win_hls(np.arange(spec_f.n), q, pf, w)
    bad = np.flatnonzero(np.asarray(full).astype(np.int64) != want)
    check(bad.size == 0, f"gen-hls full period pw={pf}: {bad.size} differ")
    run.note(checked_samples=int(idx.size + spec_f.n), lsb_errors=0)


def phase_gen_rtl(run: Run) -> None:
    """Bit-exact VHDL rounding contract through the corrected RTL ports."""
    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import make_window, rtl_cordic_coeffs
    from blackman_harris_win.model import native
    from blackman_harris_win.windows import catalog

    pw, w = run.sizes.gen_pw, 32
    q = rtl_cordic_coeffs(catalog.get("bh7").quantized(w))
    spec = WindowSpec(pw, w, rounding="rtl", overflow="wrap")
    win, _ = run.timed("make_window_rtl", functools.partial(
        make_window, "bh7", spec, coeffs=q), samples=spec.n)
    idx = check_indices(run, spec.n, 2)
    got = np.asarray(win)[idx].astype(np.int64)
    want = native.win_rtl(idx, q, pw, w, spec.precision)
    bad = np.flatnonzero(got != want)
    check(bad.size == 0, f"gen-rtl: {bad.size} of {idx.size} samples differ")
    run.note(checked_samples=int(idx.size), lsb_errors=0)


def phase_gen_bh4(run: Run) -> None:
    """BH-4 W=17 over its full 4096-point period, and its -92 dB floor."""
    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import make_window
    from blackman_harris_win.model import golden
    from blackman_harris_win.utils.spectral import window_sidelobe_db
    from blackman_harris_win.windows import catalog

    spec = WindowSpec(12, 17)
    q = catalog.get("bh4").quantized(17)
    win, _ = run.timed("make_window", functools.partial(
        make_window, "bh4", spec), samples=spec.n)
    got = np.asarray(win).astype(np.int64)
    want = np.array([golden.win_cosine_sum_hls(i, q, 12, 17)
                     for i in range(spec.n)])
    check(np.array_equal(got, want), "gen-bh4 differs from the golden model")
    floor = window_sidelobe_db(got, n_terms=4)
    check(floor <= -92.0, f"gen-bh4 floor {floor} dB above -92")
    run.note(sidelobe_db=floor)


def phase_gen_float(run: Run) -> None:
    """Native float32 BH-7 window against float64."""
    from blackman_harris_win.kernels.floatwin import float_window
    from blackman_harris_win.windows import catalog
    from blackman_harris_win.windows.catalog import float_window_value

    pw = run.sizes.gen_pw
    n = 1 << pw
    win, _ = run.timed("float_window", functools.partial(
        float_window, "bh7", pw), samples=n)
    idx = check_indices(run, n, 3)
    gold = float_window_value("bh7", idx, n)
    # error model of the outer-product f32 generator: ~2^-23 absolute per
    # harmonic at unit amplitude (tests/test_floatwin.py)
    tol = catalog.get("bh7").n_terms * 2.0**-23
    err = float(np.max(np.abs(np.asarray(win)[idx].astype(np.float64) - gold)))
    check(err < tol, f"gen-float: max error {err} >= {tol}")
    run.note(window="bh7", max_abs_error=err, tolerance=tol)


def phase_gen_comp(run: Run) -> None:
    """Compensated-f32 (hi, lo) BH-7 pair against float64."""
    from blackman_harris_win.kernels.compwin import comp_window, comp_window_pair
    from blackman_harris_win.windows.catalog import float_window_value

    pw = run.sizes.gen_pw
    n = 1 << pw
    run.timed("comp_window_pair", functools.partial(
        comp_window_pair, "bh7", pw), samples=n)
    hi, lo = comp_window("bh7", pw, pair=True)
    idx = check_indices(run, n, 4)
    pair = (np.asarray(hi)[idx].astype(np.float64)
            + np.asarray(lo)[idx].astype(np.float64))
    err = float(np.max(np.abs(pair - float_window_value("bh7", idx, n))))
    # the pair carries the window to ~3e-10 (kernels/compwin.py); 5e-9 is
    # the bound the sharded dry run holds it to
    check(err < 5e-9, f"gen-comp: pair error {err} >= 5e-9")
    run.note(window="bh7", pair_max_abs_error=err, tolerance=5e-9)


def phase_gen_taylor(run: Run) -> None:
    """TAYLOR-source 3-term window, bit-exact over its full period."""
    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import make_window
    from blackman_harris_win.windows import catalog

    pt, w, ls = run.sizes.taylor_pw, 16, 10
    spec = WindowSpec(pt, w, sin_type="taylor", lut_size=ls, rounding="hls",
                      overflow="wrap")
    q = catalog.get("blackman").quantized(w)
    tw, _ = run.timed("make_window_taylor", functools.partial(
        make_window, "blackman", spec), samples=spec.n)
    want = taylor_window_ref(np.arange(spec.n), q, pt, w, ls)
    bad = np.flatnonzero(np.asarray(tw).astype(np.int64) != want)
    check(bad.size == 0, f"gen-taylor: {bad.size} samples differ")
    run.note(window="blackman", samples=spec.n, lsb_errors=0)


def phase_gen_scan(run: Run) -> None:
    """Finding: generate -> sum through lax.scan (bench.py's harness) for
    each generator family, window never materialized whole."""
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.compwin import comp_window_block
    from blackman_harris_win.kernels.floatwin import float_window_block
    from blackman_harris_win.kernels.outerwin import window_block_outer
    from blackman_harris_win.kernels.pallas.window_kernel import window_values
    from blackman_harris_win.kernels.taylor import taylor_window_range
    from blackman_harris_win.kernels.window import make_window
    from blackman_harris_win.windows import catalog

    pw, block = run.sizes.scan_pw, run.sizes.scan_block
    n = 1 << pw
    nblocks = n // block
    m = 11
    rows = block >> m
    q7 = catalog.get("bh7").quantized(32)
    spec32 = WindowSpec(pw, 32, overflow="wrap")
    q3 = catalog.get("blackman").quantized(16)
    spec_t = WindowSpec(pw, 16, sin_type="taylor", lut_size=10,
                        rounding="hls", overflow="wrap")
    gens = {
        "int_cordic": lambda n0: window_values(
            n0 + jnp.arange(block, dtype=jnp.int32), q7, spec32),
        "outer_int": lambda n0: window_block_outer(n0, rows, q7, spec32, m=m),
        "f32": lambda n0: float_window_block(n0, rows, "bh7", pw, m=m),
        "comp": lambda n0: sum(comp_window_block(n0, rows, "bh7", pw, m=m)),
        "taylor": lambda n0: taylor_window_range(n0, block, q3, spec_t),
    }
    rates = {}
    for name, gen in gens.items():
        def scan_sum(seed, gen=gen):
            def body(acc, i):
                return acc + jnp.sum(gen(i * block)), None

            acc, _ = jax.lax.scan(body, seed,
                                  jnp.arange(nblocks, dtype=jnp.int32))
            return acc

        zero = jnp.zeros((), jnp.float32 if name in ("f32", "comp")
                         else jnp.int32)
        out, dt = run.timed(f"scan_sum_{name}", scan_sum, zero, samples=n)
        check(np.isfinite(float(out)), f"gen-scan {name}: non-finite sum")
        rates[name] = n / dt / 1e6
        if name == "int_cordic":
            # int32 wrap addition is associative: the scanned checksum must
            # equal the sum of the materialized window (checked in gen-hls)
            want = jax.jit(lambda: jnp.sum(make_window("bh7", spec32)))()
            check(int(out) == int(want), "gen-scan int_cordic checksum")
    run.note(scan_msamp_s=rates)


def phase_welch(run: Run) -> None:
    """Welch analyzer, every FFT backend: one long channel at nfft 2^20
    and a multi-channel stream at nfft 2^16."""
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.pipeline.spectral import windowed_power_spectrum

    s = run.sizes
    for label, channels, pw, t in (
        ("1ch", None, s.welch_pw,
         (s.welch_frames + 1) << (s.welch_pw - 1)),
        ("multichannel", s.mc_channels, s.mc_pw, s.mc_samples),
    ):
        nfft, hop = 1 << pw, 1 << (pw - 1)
        spec = WindowSpec(pw, 17)
        shape = (t,) if channels is None else (channels, t)
        x_np = run.rng(10 + pw).standard_normal(shape).astype(np.float32)
        ref = welch_ref(x_np, quantized_window_f64("bh4", pw, 17), nfft, hop)
        x = jnp.asarray(x_np)
        budget = welch_budget(nfft)
        times, errs = {}, {}
        for mode in ("rfft", "packed", "mxu"):
            fn = functools.partial(windowed_power_spectrum,
                                   name_or_coeffs="bh4", spec=spec, hop=hop,
                                   fft_mode=mode)
            p, dt = run.timed(f"{label}_{mode}", fn, x, samples=x.size)
            errs[mode] = rel_err(p, ref)
            times[mode] = dt
            check(errs[mode] < budget,
                  f"welch {label} {mode}: rel error {errs[mode]} >= {budget}")
        run.note(shape=list(shape), nfft=nfft, steady_s=times,
                 rel_error=errs, budget=budget)


def phase_stft(run: Run) -> None:
    """STFT frames against float64, and the WOLA round trip."""
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.pipeline.stft import quantized_stft_pair

    t = run.sizes.stft_samples
    spec = WindowSpec(12, 17)
    nfft, hop = spec.n, spec.n // 2
    fwd, inv, _ = quantized_stft_pair("bh4", spec)
    x_np = run.rng(20).standard_normal(t).astype(np.float32)
    x = jnp.asarray(x_np)
    s, _ = run.timed("stft", fwd, x, samples=t)
    win = quantized_window_f64("bh4", 12, 17)
    nf = (t - nfft) // hop + 1
    fr = np.lib.stride_tricks.sliding_window_view(
        x_np.astype(np.float64), nfft)[::hop][:nf]
    ref = np.fft.rfft(fr * win, axis=-1)
    err = float(np.max(np.abs(np.asarray(s) - ref)) / np.max(np.abs(ref)))
    budget = welch_budget(nfft)  # same f32-vs-f64 FFT derivation
    check(err < budget, f"stft frames: error {err} >= {budget}")
    y, _ = run.timed("istft", functools.partial(inv, length=t), s,
                     samples=t)
    # edges see fewer frames (ill-conditioned normalization): interior only
    rt = float(jnp.max(jnp.abs(y[nfft:-nfft] - x[nfft:-nfft])))
    check(rt < 2e-5, f"stft round trip: max error {rt} >= 2e-5")
    run.note(frames=nf, frame_error=err, budget=budget, round_trip=rt)


def phase_sdr(run: Run) -> None:
    """SDR chain (16-channel channelizer + FM discriminator): a tone's
    offset comes back out; the channelizer matches float64."""
    import jax.numpy as jnp

    from blackman_harris_win.pipeline.channelizer import (
        design_prototype, polyphase_channelize,
    )
    from blackman_harris_win.pipeline.sdr import sdr_chain

    t, c, tpb = run.sizes.sdr_samples, 16, 8
    offset = 0.005  # cycles/sample inside channel 1
    x_np = tone(run, t, 1 / c + offset, 30)
    proto = design_prototype(c, tpb)
    x = jnp.asarray(x_np)
    demod, _ = run.timed("sdr_chain", functools.partial(
        sdr_chain, prototype=proto, n_channels=c, angle_width=20), x,
        samples=t)
    check(demod.shape == (t // c - tpb, c), f"sdr shape {demod.shape}")
    f1 = float(jnp.mean(demod[:, 1].astype(jnp.float32))) / (1 << 20)
    check(abs(f1 - offset * c) < 2e-3, f"sdr tone offset {f1}")

    seg = run.sizes.sdr_segment
    y, _ = run.timed("channelize_segment", functools.partial(
        polyphase_channelize, prototype=proto, n_channels=c), x[:seg],
        samples=seg)
    ref = channelize_ref(x_np[:seg], proto, c)
    err = float(np.max(np.abs(np.asarray(y) - ref)) / np.max(np.abs(ref)))
    # f32 FIR of tpb taps plus a log2(C)-stage FFT; x32 margin.  TF32
    # products (~2^-11) would exceed it.
    budget = 32 * (tpb + math.log2(c)) * EPS32
    check(err < budget, f"channelizer error {err} >= {budget}")
    run.note(tone_offset=f1, expected=offset * c, channelizer_error=err,
             budget=budget)


def _ddc_mix_ref(x_np, idx, fw: int, pw: int, w: int, flavor: str):
    """Integer mixer products at indices ``idx`` from the C++ NCO oracle."""
    from blackman_harris_win.model import native
    from blackman_harris_win.pipeline.ddc import MIX_IN_BITS

    amp = np.float32((1 << MIX_IN_BITS) - 1)
    xq = np.round(x_np[idx] * amp).astype(np.int64)  # f32 product, as jnp
    ph = (idx.astype(np.int64) * fw) & ((1 << pw) - 1)
    nco = native.cordic_dds48 if flavor == "dds48" else native.cordic_scaled
    c, ns = nco(ph, pw, w)
    return xq, xq * c, xq * ns


def phase_ddc(run: Run) -> None:
    """DDC (CORDIC NCO, integer mixer, decim-4 64-tap FIR) with both NCO
    flavors; plus the end-to-end vs mixer-only + FIR-only finding."""
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.pipeline.ddc import (
        MIX_IN_BITS, ddc, freq_word, mix_iq_int,
    )
    from blackman_harris_win.pipeline.fir import decimating_fir, design_lowpass

    t, dec, ntaps, pw, w = run.sizes.ddc_samples, 4, 64, 20, 16
    fc, df = 1 / 8, 0.003
    x_np = tone(run, t, fc + df, 40)
    x = jnp.asarray(x_np)
    fw = freq_word(fc, pw)
    h = design_lowpass(ntaps, 0.8 / dec)
    halo = ntaps - dec
    amp = float((1 << MIX_IN_BITS) - 1)
    scale = 1.0 / (amp * (1 << (w - 2)))
    for flavor in run.sizes.ddc_flavors:
        bb, t_e2e = run.timed(f"ddc_{flavor}", functools.partial(
            ddc, freq=fc, decim=dec, taps=ntaps, phase_width=pw,
            data_width=w, flavor=flavor), x, samples=t)
        check(bb.shape == (2, t // dec), f"ddc shape {bb.shape}")

        idx = check_indices(run, t, 41)
        mix = jax.jit(functools.partial(mix_iq_int, fw=fw, phase_width=pw,
                                        data_width=w, flavor=flavor))
        xq, mi_ref, mq_ref = _ddc_mix_ref(x_np, idx, fw, pw, w, flavor)
        mi, mq = mix(jnp.asarray(xq, jnp.int32), jnp.asarray(idx, jnp.int32))
        check(np.array_equal(np.asarray(mi), mi_ref)
              and np.array_equal(np.asarray(mq), mq_ref),
              f"ddc {flavor}: mixer products differ from the oracle NCO")

        seg = run.sizes.ddc_segment
        m0 = int(run.rng(42).integers(halo // dec, t // dec - seg))
        span = np.arange(m0 * dec - halo, (m0 + seg) * dec)
        _, si, sq = _ddc_mix_ref(x_np, span, fw, pw, w, flavor)
        mixed = np.stack([si, sq]).astype(np.float64) * scale
        ref = np.stack([
            np.correlate(mixed[j], h, "valid")[::dec] for j in (0, 1)])
        got = np.asarray(bb[:, m0:m0 + seg], np.float64)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        # f32 rounding of the scaled products (2 roundings) and a 64-tap
        # f32 accumulation; x8 margin.  TF32 products would exceed it.
        budget = 8 * (ntaps + 2) * EPS32
        check(err < budget, f"ddc {flavor}: baseband error {err} >= {budget}")
        f_meas = baseband_freq(bb, dec)
        check(abs(f_meas - df) < 2e-4, f"ddc {flavor}: tone {f_meas}")
        del bb

        def mixer(x, flavor=flavor):
            xq = jnp.round(x * jnp.float32(amp)).astype(jnp.int32)
            n = jnp.arange(x.shape[-1], dtype=jnp.int32)
            a, b = mix_iq_int(xq, n, fw, pw, w, flavor)
            return jnp.stack([a, b]).astype(jnp.float32) * jnp.float32(scale)

        m2, t_mix = run.timed(f"mixer_only_{flavor}", mixer, x, samples=t)
        _, t_fir = run.timed(f"fir_only_{flavor}", functools.partial(
            decimating_fir, taps=h, decim=dec), m2, samples=t)
        del m2
        run.note(flavor=flavor, baseband_error=err, budget=budget,
                 tone=f_meas, e2e_s=t_e2e, mixer_s=t_mix, fir_s=t_fir,
                 e2e_over_parts=t_e2e / (t_mix + t_fir))


def phase_cli(run: Run) -> None:
    """The CLI's ``spectrum`` command in-process, on an i16 capture read
    through the native stream-IO runtime."""
    from blackman_harris_win.__main__ import main

    t, pw = run.sizes.cli_samples, run.sizes.cli_pw
    nfft, hop = 1 << pw, 1 << (pw - 1)
    t -= (t - nfft) % hop
    raw = np.clip(np.round(3000.0 * run.rng(50).standard_normal(t)),
                  -32768, 32767).astype("<i2")
    run.workdir.mkdir(parents=True, exist_ok=True)
    cap, out = run.workdir / "capture.i16", run.workdir / "spectrum.npy"
    raw.tofile(cap)
    argv = ["spectrum", "bh4", "--input", str(cap), "--format", "i16",
            "--scale", str(2.0**-15), "--phase-width", str(pw),
            "--out", str(out)]
    t0 = time.perf_counter()
    rc = main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli exit code {rc}")
    p = np.load(out)
    ref = welch_ref(raw.astype(np.float64) * 2.0**-15,
                    quantized_window_f64("bh4", pw, 17), nfft, hop)
    err = rel_err(p, ref)
    budget = welch_budget(nfft)
    check(err < budget, f"cli spectrum: rel error {err} >= {budget}")
    run.emit("timing " + json.dumps({
        "phase": run.phase, "step": "cli_spectrum_eager_wall_s",
        "wall_s": wall, "msamp_s": t / wall / 1e6}))
    run.note(samples=t, rel_error=err, budget=budget)


PHASES = {
    "gen-hls": phase_gen_hls,
    "gen-rtl": phase_gen_rtl,
    "gen-bh4": phase_gen_bh4,
    "gen-float": phase_gen_float,
    "gen-comp": phase_gen_comp,
    "gen-taylor": phase_gen_taylor,
    "gen-scan": phase_gen_scan,
    "welch": phase_welch,
    "stft": phase_stft,
    "sdr": phase_sdr,
    "ddc": phase_ddc,
    "cli": phase_cli,
}


# ---------------------------------------------------------------------------
# four-card phases (--chips 4)
# ---------------------------------------------------------------------------

def _on_all(arr, n: int, what: str) -> None:
    got = len(arr.sharding.device_set)
    check(got == n, f"{what}: output spans {got} devices, not {n}")


def sharded_phases(run: Run, n_dev: int) -> None:
    """Sharded generation, Welch, STFT/ISTFT, SDR and DDC on a (2, 2)
    mesh, each against its single-device counterpart."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.dist.generate import sharded_window
    from blackman_harris_win.dist.mesh import make_mesh
    from blackman_harris_win.kernels.window import make_window
    from blackman_harris_win.pipeline.ddc import ddc, make_sharded_ddc
    from blackman_harris_win.pipeline.sdr import make_sharded_sdr_chain, sdr_chain
    from blackman_harris_win.pipeline.channelizer import design_prototype
    from blackman_harris_win.pipeline.spectral import (
        make_sharded_welch, windowed_power_spectrum,
    )
    from blackman_harris_win.pipeline.stft import (
        make_sharded_istft, make_sharded_stft, quantized_stft_pair,
    )
    from blackman_harris_win.windows import catalog

    s = run.sizes
    mesh = make_mesh(blocks=2, channels=n_dev // 2)
    by_cb = NamedSharding(mesh, P("channels", "blocks"))
    by_b = NamedSharding(mesh, P("blocks"))

    run.phase = "sharded-gen"
    pw = s.gen_pw
    spec = WindowSpec(pw, 32, overflow="wrap")
    q7 = catalog.get("bh7").quantized(32)
    w_sh, _ = run.timed("sharded_window", lambda: sharded_window(
        q7, spec, mesh), samples=spec.n, jit=False)
    _on_all(w_sh, n_dev, "sharded_window")
    w_1 = jax.jit(functools.partial(make_window, "bh7", spec))()
    check(np.array_equal(np.asarray(w_sh), np.asarray(w_1)),
          "sharded_window != single-device make_window")
    run.note(bitwise_equal=True, devices=n_dev)
    del w_sh, w_1

    run.phase = "sharded-welch"
    pw = s.sh_welch_pw
    nfft, hop = 1 << pw, 1 << (pw - 1)
    spec = WindowSpec(pw, 17)
    d4 = catalog.get("bh4")
    x_np = run.rng(60).standard_normal(
        (s.sh_welch_channels, s.sh_welch_samples)).astype(np.float32)
    x = jax.device_put(x_np, by_cb)
    step = make_sharded_welch(mesh, spec, d4.quantized(17), d4.shift, nfft,
                              hop)
    p_sh, _ = run.timed("make_sharded_welch", step, x, samples=x.size)
    _on_all(p_sh, n_dev, "sharded welch")
    # the circular halo makes the shards' frames those of x extended by
    # its own head
    xe = jnp.asarray(np.concatenate([x_np, x_np[:, :nfft - hop]], axis=1))
    p_1 = jax.jit(functools.partial(
        windowed_power_spectrum, name_or_coeffs="bh4", spec=spec,
        hop=hop))(xe)
    err = rel_err(p_sh, np.asarray(p_1, np.float64))
    check(err < welch_budget(nfft), f"sharded welch vs single: {err}")
    run.note(rel_error=err, budget=welch_budget(nfft))
    del x, xe, p_sh, p_1

    run.phase = "sharded-stft"
    pw = s.sh_stft_pw
    nfft, hop = 1 << pw, 1 << (pw - 1)
    spec = WindowSpec(pw, 17)
    x_np = run.rng(61).standard_normal(
        (s.sh_stft_channels, s.sh_stft_samples)).astype(np.float32)
    x = jax.device_put(x_np, by_cb)
    fwd = make_sharded_stft(mesh, spec, d4.quantized(17), d4.shift, nfft, hop)
    inv = make_sharded_istft(mesh, spec, d4.quantized(17), d4.shift, nfft,
                             hop)
    fr, _ = run.timed("make_sharded_stft", fwd, x, samples=x.size)
    y, _ = run.timed("make_sharded_istft", inv, fr, samples=x.size)
    _on_all(fr, n_dev, "sharded stft")
    _on_all(y, n_dev, "sharded istft")
    f1, _, _ = quantized_stft_pair("bh4", spec)
    xe = jnp.asarray(np.concatenate([x_np, x_np[:, :nfft - hop]], axis=1))
    fr_1 = np.asarray(jax.jit(f1)(xe))
    fe = float(np.max(np.abs(np.asarray(fr) - fr_1)) / np.max(np.abs(fr_1)))
    check(fe < welch_budget(nfft), f"sharded stft vs single: {fe}")
    rt = float(np.max(np.abs(np.asarray(y) - x_np)))
    check(rt < 2e-5, f"sharded stft round trip {rt}")
    run.note(frame_error=fe, round_trip=rt)
    del x, xe, fr, y

    run.phase = "sharded-sdr"
    t, c, tpb = s.sh_sdr_samples, 16, 8
    offset = 0.005
    x_np = tone(run, t, 1 / c + offset, 62)
    sdr = make_sharded_sdr_chain(mesh, c, tpb, angle_width=20)
    d_sh, _ = run.timed("make_sharded_sdr_chain", sdr,
                        jax.device_put(x_np, by_b), samples=t)
    _on_all(d_sh, n_dev, "sharded sdr")
    f1 = float(jnp.mean(d_sh[:, 1].astype(jnp.float32))) / (1 << 20)
    check(abs(f1 - offset * c) < 2e-3, f"sharded sdr tone {f1}")
    proto = design_prototype(c, tpb)
    halo = c * tpb
    xe = jnp.asarray(np.concatenate([x_np[t - halo:], x_np]))
    d_1 = np.asarray(jax.jit(functools.partial(
        sdr_chain, prototype=proto, n_channels=c, angle_width=20))(xe))
    d_sh = np.asarray(d_sh)
    check(d_sh.shape == d_1.shape, f"sharded sdr shape {d_sh.shape}")
    # channel outputs are rounded to ints from f32 FIR results whose last
    # ulp can differ between the sharded and whole-stream convolutions
    agree = float(np.mean(d_sh == d_1))
    worst = int(np.max(np.abs(d_sh.astype(np.int64) - d_1)))
    check(agree > 0.999 and worst < (1 << 10),
          f"sharded sdr vs single: agree {agree}, worst {worst} LSB")
    run.note(tone_offset=f1, exact_fraction=agree, worst_lsb=worst)
    del d_sh, xe

    run.phase = "sharded-ddc"
    t, dec = s.sh_ddc_samples, 4
    fc, df = 1 / 8, 0.003
    x_np = tone(run, t, fc + df, 63)
    x_b = jax.device_put(x_np, by_b)
    budget = 8 * (64 + 2) * EPS32
    for flavor in s.ddc_flavors:
        step = make_sharded_ddc(mesh, phase_width=20, data_width=16, freq=fc,
                                decim=dec, taps=64, flavor=flavor)
        bb, _ = run.timed(f"make_sharded_ddc_{flavor}", step, x_b, samples=t)
        _on_all(bb, n_dev, f"sharded ddc {flavor}")
        bb_1 = jax.jit(functools.partial(
            ddc, freq=fc, decim=dec, taps=64, phase_width=20, data_width=16,
            flavor=flavor))(jnp.asarray(x_np))
        a, b = np.asarray(bb, np.float64), np.asarray(bb_1, np.float64)
        err = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        check(err < budget, f"sharded ddc {flavor} vs single: {err}")
        f_meas = baseband_freq(a, dec)
        check(abs(f_meas - df) < 2e-4, f"sharded ddc {flavor} tone {f_meas}")
        run.note(flavor=flavor, rel_error=err, budget=budget, tone=f_meas)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=sorted(PHASES),
                    help="run one one-card phase only")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases on four cards")
    args = ap.parse_args(argv)

    import jax

    from blackman_harris_win.utils.compile_cache import use_compile_cache
    from blackman_harris_win.utils.profiling import (
        card_name_and_power_limit, require_gpu,
    )

    devices = require_gpu()
    if jax.config.read("jax_enable_x64"):
        raise SystemExit("chip_smoke runs with x64 off (the production "
                         "regime); unset JAX_ENABLE_X64")
    if len(devices) < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} devices, "
                         f"JAX sees {len(devices)}")
    print("card:", card_name_and_power_limit(), flush=True)
    print("compile cache:", use_compile_cache(), flush=True)
    print("jax", jax.__version__, "devices:",
          [d.device_kind for d in devices], flush=True)

    def emit(line):
        print(line, flush=True)

    workdir = REPO / ".smoke_tmp"
    run = Run(FULL, args.seed, workdir, emit)
    t0 = time.perf_counter()
    try:
        if args.chips == 4:
            sharded_phases(run, 4)
        else:
            names = [args.phase] if args.phase else list(PHASES)
            for name in names:
                run.phase = name
                t1 = time.perf_counter()
                PHASES[name](run)
                emit(f"phase {name} ok in {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
