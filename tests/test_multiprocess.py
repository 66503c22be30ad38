"""True multi-process distributed execution, simulated on CPU (SURVEY.md §4:
"multi-host tests using jax.distributed + CPU meshes so sharded ==
single-device bit-for-bit"; round-2 VERDICT item 2).

Spawns 2 coordinated OS processes (tests/multiproc_child.py), each with its
own JAX runtime and 4 virtual CPU devices, brought up through the production
``dist.multihost.initialize()`` -> ``jax.distributed.initialize`` path with
an explicit localhost coordinator.  Cross-process collectives run over Gloo.
The children assert sharded-vs-single-device equality (window generation
bit-for-bit, Welch, STFT frames bit-for-bit, WOLA round trip) with the
'blocks' axis spanning the process boundary, plus the pod_mesh layout and
``process_block_range`` ownership on the real 2-process device grid.

The children run with ``JAX_PLATFORMS=cpu`` and their own ``XLA_FLAGS``, so
they are clean CPU-only interpreters whatever the parent's environment.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

_HERE = pathlib.Path(__file__).resolve().parent
_REPO = _HERE.parent
_NPROCS = 2
_DEVS_PER_PROC = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(devs_per_proc: int = _DEVS_PER_PROC) -> dict:
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs_per_proc}"
    )
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).rstrip(os.pathsep)
    return env


def _spawn_children(script: str, nprocs: int, devs_per_proc: int):
    port = _free_port()
    env = _child_env(devs_per_proc)
    procs = [
        subprocess.Popen(
            [sys.executable, str(_HERE / script),
             str(port), str(i), str(nprocs)],
            env=env,
            stdout=subprocess.PIPE,
            # stderr captured SEPARATELY: merging it into stdout let jax
            # warnings interleave mid-line with the MP_RESULT JSON under
            # load (observed as a flaky json.decode error in full-suite
            # runs on this 2-core host)
            stderr=subprocess.PIPE,
            text=True,
            cwd=str(_REPO),
        )
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID of a process we spawned
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{out}\n{err}"
    results = []
    for out, err in outs:
        line = next(
            l for l in out.splitlines() if l.startswith("MP_RESULT ")
        )
        results.append(json.loads(line[len("MP_RESULT "):]))
    return results


@pytest.fixture(scope="module")
def mp_results():
    return _spawn_children("multiproc_child.py", _NPROCS, _DEVS_PER_PROC)


@pytest.fixture(scope="module")
def mp4_results():
    """4 processes x 2 devices: the (channels=2, blocks=4) grid whose
    channel axis crosses the process boundary (multiproc_child4.py)."""
    return _spawn_children("multiproc_child4.py", 4, 2)


def test_both_processes_pass(mp_results):
    assert len(mp_results) == _NPROCS
    for r in mp_results:
        assert r["ok"] is True


def test_global_device_grid(mp_results):
    for r in mp_results:
        assert r["ndev"] == _NPROCS * _DEVS_PER_PROC
        assert r["nlocal"] == _DEVS_PER_PROC
    assert {r["pid"] for r in mp_results} == set(range(_NPROCS))


def test_sharded_generation_bit_exact_per_process(mp_results):
    for r in mp_results:
        assert r["gen_shards_bit_exact"] == _DEVS_PER_PROC


def test_process_block_ownership_is_a_partition(mp_results):
    n = 4096  # spec.n in the child
    ranges = sorted(r["block_range_a"] for r in mp_results)
    assert ranges == [[0, n // 2], [n // 2, n]]


def test_cross_process_welch_and_wola(mp_results):
    for r in mp_results:
        assert r["welch_max_relerr"] < 1e-6
        assert r["stft_frames_bit_exact"] is True
        assert r["wola_roundtrip_max_err"] < 2e-5


def test_4proc_channels_grid(mp4_results):
    """VERDICT r3 item 5: owned_block_cols' non-zero-channel-row branch on
    a REAL 4-process grid — processes 2/3 own devices only on channel
    row 1, and the channel-axis psum crosses the process boundary."""
    assert len(mp4_results) == 4
    n = 4096
    for r in mp4_results:
        assert r["ok"] is True
        assert r["ndev"] == 8 and r["nlocal"] == 2
        assert r["gen_shards_bit_exact"] == 2
        assert r["channel_psum_ok"] is True
    by_pid = {r["pid"]: r for r in mp4_results}
    assert by_pid[0]["owned_cols"] == [0, 2] == by_pid[2]["owned_cols"]
    assert by_pid[1]["owned_cols"] == [2, 4] == by_pid[3]["owned_cols"]
    assert by_pid[2]["block_range"] == [0, n // 2]  # non-zero-row owner
    assert by_pid[3]["block_range"] == [n // 2, n]


def test_mp_scaling_harness_runs():
    """bench_scaling_mp's full driver path at 1/2 processes with tiny
    sizes — keeps the weak-scaling artifact harness green."""
    proc = subprocess.run(
        [sys.executable, str(_REPO / "bench_scaling_mp.py"),
         "--procs", "1", "2", "--pw-per-device", "12",
         "--frames-per-device", "4", "--reps", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(_REPO),
        env=_child_env(2),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines()
            if l.startswith("{\"metric\"")][-1]
    out = json.loads(line)
    assert out["metric"] == "mp_weak_scaling_efficiency_cpu_gloo"
    assert len(out["rows"]) == 2
    assert out["rows"][1]["nprocs"] == 2 and out["rows"][1]["ndev"] == 4
