"""Benchmark: streaming quantized window generation on one NVIDIA GPU.

Headline: the reference's own configuration — the 64M-point (2^26) 7-term
Blackman-Harris window at W=32 (<= -180 dB sidelobe floor), bit-exact
fixed-point CORDIC (two-limb int32 datapath, x64 off), generated in ONE
device dispatch (16 x 4M-block lax.scan with a checksum reduction so
nothing elides and the window is never written to device memory whole).

The reference's implied throughput is 1 sample/clock/core x 400 MHz
= 400 Msamples/s on a Kintex Ultrascale XCKU040-2 (BASELINE.md).
``vs_baseline`` = speedup over that.  Timing is the host clock around
``block_until_ready``: the median of 5 calls after one compile-and-warm
call.

Correctness gate before timing: a fresh random 4096-sample block (seed
printed, clock-derived) asserted 0-LSB against the native C++ oracle, plus
Python-golden spot checks — the full chain of evidence, re-rolled each run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
naming the device kind, count and the card's power limit.  Exits non-zero
when JAX's first device is not a GPU.
"""

import json
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.pallas.window_kernel import window_values
    from blackman_harris_win.model import golden, native
    from blackman_harris_win.utils.compile_cache import use_compile_cache
    from blackman_harris_win.utils.profiling import (
        card_name_and_power_limit,
        cordic_window_int_ops,
        require_gpu,
        steady_seconds,
    )
    from blackman_harris_win.windows import catalog

    devices = require_gpu()
    use_compile_cache()
    card = card_name_and_power_limit()

    pw, w = 26, 32
    spec = WindowSpec(phase_width=pw, data_width=w, overflow="wrap")
    coeffs_q = catalog.get("bh7").quantized(w)

    block = 1 << 22
    nblocks = (1 << pw) // block

    @jax.jit
    def gen_all(seed):
        def body(acc, i):
            n = i * block + jnp.arange(block, dtype=jnp.int32)
            wv = window_values(n, coeffs_q, spec)
            return acc + jnp.sum(wv), None

        s, _ = jax.lax.scan(
            body, seed, jnp.arange(nblocks, dtype=jnp.int32)
        )
        return s

    # correctness gate: random 4096-sample block vs the native C++ oracle
    # (seeded per run), plus Python-golden spot checks
    seed = int(time.time()) & 0xFFFFFF
    n0 = int(np.random.default_rng(seed).integers(0, (1 << pw) - 4096))

    @jax.jit
    def check_block(b0):
        n = b0 + jnp.arange(4096, dtype=jnp.int32)
        return window_values(n, coeffs_q, spec)

    blk = np.asarray(check_block(jnp.int32(n0))).astype(np.int64)
    want = native.win_hls(n0 + np.arange(4096, dtype=np.int64), coeffs_q, pw, w)
    if not (blk == want).all():
        raise SystemExit(
            f"golden mismatch: seed={seed} n0={n0} "
            f"first_bad={int(np.argmax(blk != want))}"
        )
    for i in (0, 1, 2047, 4095):
        if int(blk[i]) != golden.win_cosine_sum_hls(n0 + i, coeffs_q, pw, w):
            raise SystemExit(f"golden mismatch at n={n0 + i} (seed={seed})")

    dt = steady_seconds(gen_all, jnp.int32(0), reps=5)
    nsamples = 1 << pw
    msamps = nsamples / dt / 1e6
    print(
        json.dumps(
            {
                "metric": "bh7_w32_64M_window_gen_throughput_-180dB",
                "value": msamps,
                "unit": "Msamples/s",
                "vs_baseline": msamps / 400.0,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
                "card": card,
                "int_ops_per_sample": cordic_window_int_ops(1, 7, w, True),
                "accounting": "compute-bound; checksum reduction on "
                "device, window never written to device memory whole",
                "golden_seed": seed,
            }
        )
    )


if __name__ == "__main__":
    main()
