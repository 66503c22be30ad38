"""Throughput / roofline instrumentation.

The reference's observability is its valid-bit chains (latency made visible,
``src/cordic_dds.vhd:221-222``); the device equivalent is samples/s
counters, a roofline model against the device's published peaks, and
``jax.profiler`` trace capture (SURVEY.md §5).

Timing rule: JAX dispatch is asynchronous, so every timed region ends in
``block_until_ready`` on the result (:func:`steady_seconds`).
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax
import numpy as np

#: Published peaks per ``jax.Device.device_kind``.  Source: NVIDIA H100
#: Tensor Core GPU data sheet, SXM part, dense rates at the 700 W power
#: limit: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores.
#: A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) cannot
#: hold its top clock, so report its power limit beside any share.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12},
}


def device_peaks(device_kind: str) -> dict:
    """The published peaks of one device kind; an unknown kind raises (a
    share against a guessed peak is not a measurement)."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(DEVICE_PEAKS)}"
        ) from None


def steady_seconds(fn, *args, reps: int = 5) -> float:
    """Median host-clock seconds of ``fn(*args)`` over ``reps`` calls, each
    ended by ``block_until_ready``.  One untimed call first absorbs
    compilation; time that separately where it matters."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def cordic_window_int_ops(n_samples: int, n_terms: int, data_width: int,
                          wide: bool) -> int:
    """Analytic op-count model of the fused window kernel: per sample,
    (K-1) CORDICs x W iterations x ops/iter plus the product/accumulate
    stage."""
    per_iter = 22 if wide else 8
    per_prod = 12 if wide else 2
    k = n_terms - 1
    return n_samples * (k * data_width * per_iter + k * per_prod + n_terms)


def roofline_fields(seconds: float, device_kind: str, flops: int = 0,
                    bytes_moved: int = 0) -> dict:
    """Shares of the device's published float32 and HBM peaks reached by
    ``flops`` float32 operations and ``bytes_moved`` bytes in ``seconds``
    (0.0 where the count is not given)."""
    peaks = device_peaks(device_kind)
    return {
        "f32_flop_frac": flops / seconds / peaks["f32_flop_per_s"]
        if flops else 0.0,
        "hbm_frac": bytes_moved / seconds / peaks["hbm_bytes_per_s"]
        if bytes_moved else 0.0,
    }


@contextlib.contextmanager
def trace(dir_path: str):
    """jax.profiler trace capture contextmanager (view with tensorboard or
    xprof)."""
    jax.profiler.start_trace(dir_path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def require_gpu() -> list:
    """``jax.devices()``, or SystemExit when the first device is not a GPU:
    a device measurement never falls back to the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            "needs an NVIDIA GPU; JAX's first device is "
            f"{devices[0].platform} ({devices[0].device_kind})"
        )
    return devices


def card_name_and_power_limit() -> str:
    """Name and power limit of each visible card as ``nvidia-smi`` reports
    them, one csv line per card.  Read by a child process that does not
    touch JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
