"""Weak-scaling harness: sharded window generation + Welch analyzer
throughput per device count, with weak-scaling efficiency.

North-star (BASELINE.json): >= 90% weak-scaling efficiency at >= 2 hosts.
Real multi-host numbers need pod hardware; this harness runs the identical
code path (shard_map window gen with zero communication; ppermute halos +
psum Welch) on whatever devices exist — the single real chip, or a virtual
CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORM_NAME=cpu \
        python bench_scaling.py --devices 1 2 4 8

Weak scaling: per-device problem size is constant (``--pw-per-device`` for
generation, ``--frames-per-device`` for the analyzer), so ideal time is flat
and efficiency(n) = t(1)/t(n).  Inputs are synthesized on-device, so no
host transfer sits inside the timed region.  Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json


def run(counts, pw_per_device, nfft, hop, frames_per_device, reps,
        floor_probe=False):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.dist.generate import window_shard_fn
    from blackman_harris_win.dist.mesh import make_mesh
    from blackman_harris_win.pipeline.spectral import make_sharded_welch
    from blackman_harris_win.utils.profiling import steady_seconds
    from blackman_harris_win.windows import catalog

    d4 = catalog.get("bh4")
    q4 = d4.quantized(17)
    gen_t, welch_t, floor_t = {}, {}, {}

    for n in counts:
        if n & (n - 1):
            raise ValueError(f"device counts must be powers of two, got {n}")
        mesh = make_mesh(blocks=n)

        # --- communication-free sharded window generation (SP-like) ---
        pw = pw_per_device + (n.bit_length() - 1)  # total 2^pw, per-dev 2^ppd
        gspec = WindowSpec(pw, 17)
        block = gspec.n // n
        gen = jax.jit(
            shard_map(
                window_shard_fn(q4, gspec, "blocks", block),
                mesh=mesh,
                in_specs=(),
                out_specs=P("blocks"),
            )
        )
        gen_t[n] = steady_seconds(gen, reps=reps)

        # --- sharded Welch analyzer (halo ppermute + psum) ---
        wspec = WindowSpec(nfft.bit_length() - 1, 17)
        step = make_sharded_welch(mesh, wspec, q4, d4.shift, nfft, hop)
        step = jax.jit(step)
        shd = NamedSharding(mesh, P("channels", "blocks"))
        make_x = jax.jit(
            lambda k: jax.random.normal(
                k, (2, n * frames_per_device * hop), jnp.float32
            ),
            out_shardings=shd,
        )
        x = make_x(jax.random.PRNGKey(0))
        welch_t[n] = steady_seconds(step, x, reps=reps)

        if floor_probe:
            # dispatch floor at this device count: the identical sharded
            # gen program at trivial per-device work (2^6 samples) — what a
            # zero-work dispatch through jit + shard_map + wait costs
            fspec = WindowSpec(6 + (n.bit_length() - 1), 17)
            fgen = jax.jit(
                shard_map(
                    window_shard_fn(q4, fspec, "blocks", fspec.n // n),
                    mesh=mesh,
                    in_specs=(),
                    out_specs=P("blocks"),
                )
            )
            floor_t[n] = steady_seconds(fgen, reps=reps)

    base = counts[0]
    gen_eff = {n: round(gen_t[base] / gen_t[n], 3) for n in counts}
    welch_eff = {n: round(welch_t[base] / welch_t[n], 3) for n in counts}
    top = counts[-1]
    return {
        "metric": "weak_scaling_efficiency",
        "value": round(min(gen_eff[top], welch_eff[top]), 3),
        "unit": "fraction_vs_ideal",
        "devices": counts,
        "gen_seconds": {n: round(t, 4) for n, t in gen_t.items()},
        "welch_seconds": {n: round(t, 4) for n, t in welch_t.items()},
        "gen_efficiency": gen_eff,
        "welch_efficiency": welch_eff,
        **({"dispatch_floor_seconds":
            {n: round(t, 4) for n, t in floor_t.items()}}
           if floor_t else {}),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, nargs="+", default=None)
    p.add_argument("--pw-per-device", type=int, default=18)
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--hop", type=int, default=512)
    p.add_argument("--frames-per-device", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    import jax

    avail = len(jax.devices())
    counts = args.devices or [n for n in (1, 2, 4, 8, 16, 32) if n <= avail]
    out = run(
        counts, args.pw_per_device, args.nfft, args.hop,
        args.frames_per_device, args.reps,
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
