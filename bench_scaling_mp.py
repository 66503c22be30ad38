"""Multi-PROCESS weak-scaling harness (CPU, Gloo) — honest resource pinning.

Without pinning, every process's XLA CPU thread pool spans the whole host,
so p processes contend p-for-1 on fixed silicon and the number measures the
host, not the framework.  This harness makes the measurement mean
something:

- **CPU affinity**: each child is pinned (``taskset``) to its own core set
  of ``--cores-per-proc`` cores, so per-process silicon is CONSTANT across
  process counts — the actual weak-scaling contract.  When
  nprocs x cores_per_proc exceeds the host, the pin sets wrap and the run
  is flagged ``oversubscribed``; its ideal efficiency is
  host_cores / (nprocs x cores_per_proc), reported as
  ``contention_bound`` with the measured value normalized against it.
- **Compute-bound sizing**: per-device work auto-doubles until the 1-proc
  generation takes >= ``--min-seconds`` (default 2 s), so Gloo/dispatch
  latency is amortized out of the efficiency (it is *measured separately*
  instead: a trivial-work dispatch through the identical jit + shard_map +
  sync path, reported as ``dispatch_floor_seconds``).

    python bench_scaling_mp.py --out scaling.json

All processes still share ONE physical host over Gloo-on-localhost, so this
remains a harness-correctness artifact, not a multi-host measurement.  But
the efficiency reported here is the framework's own overhead (comm +
harness), not core contention.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(devs_per_proc: int) -> dict:
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devs_per_proc}"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).rstrip(os.pathsep)
    return env


def _pin_cores(pid: int, cores_per_proc: int, host_cores: int) -> str:
    """Disjoint core ranges per process, wrapping when oversubscribed."""
    start = (pid * cores_per_proc) % host_cores
    cores = [(start + j) % host_cores for j in range(cores_per_proc)]
    return ",".join(str(c) for c in sorted(set(cores)))


def child(argv) -> int:
    port, pid, nprocs, dpp = (int(a) for a in argv[:4])
    ppd, fpd, reps = (int(a) for a in argv[4:7])

    import jax

    from blackman_harris_win.dist import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs
    ndev = len(jax.devices())
    assert ndev == nprocs * dpp

    import bench_scaling

    res = bench_scaling.run(
        counts=[ndev], pw_per_device=ppd, nfft=1024, hop=512,
        frames_per_device=fpd, reps=reps, floor_probe=True,
    )
    if pid == 0:
        print("MP_SCALING " + json.dumps({
            "nprocs": nprocs, "ndev": ndev,
            "gen_seconds": res["gen_seconds"][ndev],
            "welch_seconds": res["welch_seconds"][ndev],
            "floor_seconds": res["dispatch_floor_seconds"][ndev],
        }), flush=True)
    return 0


def _spawn(nprocs, devs_per_proc, ppd, fpd, reps, cores_per_proc,
           host_cores, timeout=900):
    port = _free_port()
    env = _child_env(devs_per_proc)
    procs = []
    for i in range(nprocs):
        cmd = [sys.executable, str(_REPO / "bench_scaling_mp.py"),
               "--child", str(port), str(i), str(nprocs),
               str(devs_per_proc), str(ppd), str(fpd), str(reps)]
        if cores_per_proc:
            cmd = ["taskset", "-c",
                   _pin_cores(i, cores_per_proc, host_cores)] + cmd
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=str(_REPO),
        ))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID we spawned
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"child {i}/{nprocs} failed:\n{out}")
    line = next(
        l for l in outs[0].splitlines() if l.startswith("MP_SCALING ")
    )
    return json.loads(line[len("MP_SCALING "):])


def run_mp(proc_counts, devs_per_proc, ppd, fpd, reps, cores_per_proc,
           min_seconds):
    host_cores = os.cpu_count()

    # --- compute-bound sizing: double per-device work until the PINNED
    #     1-proc generation takes >= min_seconds ---
    sizing = []
    while True:
        row1 = _spawn(1, devs_per_proc, ppd, fpd, reps, cores_per_proc,
                      host_cores)
        sizing.append({"ppd": ppd, "fpd": fpd,
                       "gen_seconds": row1["gen_seconds"],
                       "welch_seconds": row1["welch_seconds"]})
        print(json.dumps({"sizing": sizing[-1]}), flush=True)
        grown = False
        if row1["gen_seconds"] < min_seconds and ppd < 26:
            ppd += 1
            grown = True
        if row1["welch_seconds"] < min_seconds and fpd < 4096:
            fpd *= 2
            grown = True
        if not grown:
            break

    rows = [row1]
    for nprocs in proc_counts:
        if nprocs == 1:
            continue
        rows.append(_spawn(nprocs, devs_per_proc, ppd, fpd, reps,
                           cores_per_proc, host_cores))
        print(json.dumps(rows[-1]), flush=True)

    t0g, t0w = rows[0]["gen_seconds"], rows[0]["welch_seconds"]
    for r in rows:
        n = r["nprocs"]
        r["gen_efficiency"] = round(t0g / r["gen_seconds"], 3)
        r["welch_efficiency"] = round(t0w / r["welch_seconds"], 3)
        # ideal efficiency given the host's cores: 1.0 while the pinned
        # sets are disjoint, host/(n*cpp) once oversubscribed
        bound = min(1.0, host_cores / (n * cores_per_proc)) \
            if cores_per_proc else 1.0 / n
        r["contention_bound"] = round(bound, 3)
        r["gen_efficiency_vs_bound"] = round(r["gen_efficiency"] / bound, 3)
        r["welch_efficiency_vs_bound"] = round(
            r["welch_efficiency"] / bound, 3)
        r["oversubscribed"] = bound < 1.0

    # headline: the largest NON-oversubscribed count (the honest number);
    # oversubscribed rows ship with their bound-normalized values
    fair = [r for r in rows if not r["oversubscribed"]]
    top = fair[-1] if len(fair) > 1 else rows[-1]
    val = min(top["gen_efficiency_vs_bound"] if top["oversubscribed"]
              else top["gen_efficiency"],
              top["welch_efficiency_vs_bound"] if top["oversubscribed"]
              else top["welch_efficiency"])
    return {
        "metric": "mp_weak_scaling_efficiency_cpu_gloo",
        "value": round(val, 3),
        "unit": "fraction_vs_ideal",
        "headline_nprocs": top["nprocs"],
        "grade": "pinned-core weak scaling over jax.distributed + Gloo on "
                 "ONE host: per-process silicon constant (taskset), "
                 "per-device work compute-bound (gen >= "
                 f"{min_seconds:.0f} s at 1 proc); oversubscribed rows "
                 "are normalized against the host-core contention bound",
        "cores_per_proc": cores_per_proc,
        "host_cores": host_cores,
        "sizing_trace": sizing,
        "rows": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--child", nargs="+", default=None,
                   help="internal: run as a coordinated child process")
    p.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--devs-per-proc", type=int, default=2)
    p.add_argument("--pw-per-device", type=int, default=21)
    p.add_argument("--frames-per-device", type=int, default=256)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cores-per-proc", type=int, default=1)
    p.add_argument("--min-seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    args = p.parse_args(argv)

    if args.child is not None:
        return child(args.child)

    out = run_mp(args.procs, args.devs_per_proc, args.pw_per_device,
                 args.frames_per_device, args.reps, args.cores_per_proc,
                 args.min_seconds)
    out["per_device_gen_samples"] = 1 << max(
        s["ppd"] for s in out["sizing_trace"])
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
