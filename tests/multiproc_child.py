"""Worker for the simulated multi-process distributed test (SURVEY.md §4's
multi-host clause): run as one of N coordinated OS processes, each with its
own JAX runtime and a slice of virtual CPU devices, brought up through the
production ``dist.multihost.initialize()`` path.

Launched by tests/test_multiprocess.py with a cleaned environment
(JAX_PLATFORMS=cpu, 4 virtual devices per process).  Asserts,
on the real 2-process grid:

- ``multihost.initialize`` reaches process_count == N (jax.distributed +
  Gloo cross-process collectives);
- ``pod_mesh`` lays 'blocks' within hosts and 'channels' across hosts
  (device-to-process grid checked explicitly);
- sharded window generation (dist.generate.sharded_window) is bit-for-bit
  equal to the single-device kernel on every addressable shard — with the
  'blocks' axis *spanning the process boundary*;
- the sharded Welch analyzer (cross-process ppermute halo + psum) matches
  the single-device ``welch_power`` of the same signal;
- the sharded STFT's frames match the single-device periodic ``stft``
  bit-for-bit, and the sharded WOLA inverse reconstructs the input across
  the process boundary;
- ``process_block_range`` returns each process's true sample ownership on
  both mesh layouts.

Prints one final line ``MP_RESULT {json}`` consumed by the parent test.
"""

import json
import sys


def main(argv) -> int:
    port, pid, nprocs = int(argv[1]), int(argv[2]), int(argv[3])

    import jax

    from blackman_harris_win.dist import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.process_index() == pid

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.dist.generate import sharded_window
    from blackman_harris_win.dist.multihost import (
        pod_mesh,
        process_block_range,
    )
    from blackman_harris_win.kernels.window import window_samples
    from blackman_harris_win.pipeline.spectral import (
        make_sharded_welch,
        welch_power,
        window_scale,
    )
    from blackman_harris_win.pipeline.stft import (
        make_sharded_istft,
        make_sharded_stft,
        stft,
    )
    from blackman_harris_win.windows import catalog

    ndev = len(jax.devices())
    nlocal = len(jax.local_devices())
    out = {"pid": pid, "ndev": ndev, "nlocal": nlocal}

    # ---- layout A: channels=1 -> 'blocks' spans the process boundary
    # (the DCN-crossing case: halos and psum cross processes)
    mesh_a = pod_mesh(channels=1)
    grid_a = np.vectorize(lambda d: d.process_index)(mesh_a.devices)
    # device order groups by process: left half of the block row is proc 0
    assert grid_a.shape == (1, ndev)
    assert (grid_a[0, : ndev // 2] == 0).all()
    assert (grid_a[0, ndev // 2 :] == 1).all()

    # sharded generation, bit-for-bit on every addressable shard
    spec = WindowSpec(phase_width=12, data_width=17)
    d = catalog.get("bh4")
    q = d.quantized(spec.data_width)
    w = sharded_window(q, spec, mesh_a)
    expected = np.asarray(
        window_samples(jnp.arange(spec.n, dtype=jnp.int32), q, spec)
    )
    nshards = 0
    for s in w.addressable_shards:
        sl = s.index[0]
        assert (np.asarray(s.data) == expected[sl]).all(), sl
        nshards += 1
    assert nshards == nlocal
    out["gen_shards_bit_exact"] = nshards

    # process ownership along 'blocks': each process owns a contiguous half
    lo, hi = process_block_range(spec.n, mesh_a)
    assert (lo, hi) == (pid * spec.n // nprocs, (pid + 1) * spec.n // nprocs)
    out["block_range_a"] = [lo, hi]

    # ---- sharded Welch across the process boundary
    nfft, hop = 256, 128
    wspec = WindowSpec(phase_width=8, data_width=17)
    c, t = 2, ndev * 512  # (C, T), T/ndev = 512 samples per shard
    n = np.arange(t)
    xnp = np.stack(
        [
            np.sin(2 * np.pi * 16 / nfft * n) + 0.25 * np.sin(2 * np.pi * 0.31 * n),
            np.sign(np.sin(2 * np.pi * 5 / nfft * n)),
        ]
    ).astype(np.float32)

    sharding = NamedSharding(mesh_a, P("channels", "blocks"))
    x = jax.make_array_from_callback(
        (c, t), sharding, lambda idx: xnp[idx]
    )
    welch = jax.jit(
        make_sharded_welch(mesh_a, wspec, q, d.shift, nfft, hop)
    )
    p = welch(x)
    # reference: single-device periodic Welch of the same signal (the sharded
    # analyzer frames circularly via the halo, so wrap the input by hand)
    win = expected_win = None
    wq = np.asarray(
        window_samples(jnp.arange(nfft, dtype=jnp.int32), q, wspec)
    )
    win = wq.astype(np.float32) * np.float32(window_scale(wspec, d.shift))
    xwrap = np.concatenate([xnp, xnp[:, : nfft - hop]], axis=1)
    p_ref = np.asarray(welch_power(jnp.asarray(xwrap), jnp.asarray(win), nfft, hop))
    p_loc = np.asarray(p.addressable_shards[0].data)
    assert p_loc.shape == (c, nfft // 2 + 1)
    assert np.allclose(p_loc, p_ref, rtol=1e-5, atol=1e-7), np.abs(
        p_loc - p_ref
    ).max()
    assert int(p_loc[0].argmax()) == 16 and int(p_loc[1].argmax()) == 5
    out["welch_max_relerr"] = float(
        np.abs(p_loc - p_ref).max() / np.abs(p_ref).max()
    )

    # ---- sharded STFT bit-equality + WOLA exact inverse across processes
    fwd = jax.jit(make_sharded_stft(mesh_a, wspec, q, d.shift, nfft, hop))
    inv = jax.jit(make_sharded_istft(mesh_a, wspec, q, d.shift, nfft, hop))
    s = fwd(x)
    s_ref = np.asarray(
        stft(jnp.asarray(xwrap), jnp.asarray(win), nfft, hop)
    )
    for sh in s.addressable_shards:
        blk = sh.index[1]
        assert (np.asarray(sh.data) == s_ref[:, blk, :]).all(), blk
    y = inv(s)
    for sh in y.addressable_shards:
        idx = sh.index
        assert np.allclose(np.asarray(sh.data), xnp[idx], atol=2e-5), idx
    out["stft_frames_bit_exact"] = True
    out["wola_roundtrip_max_err"] = float(
        max(
            np.abs(np.asarray(sh.data) - xnp[sh.index]).max()
            for sh in y.addressable_shards
        )
    )

    # ---- layout B: channels across processes ('blocks' stays intra-host)
    mesh_b = pod_mesh(channels=nprocs)
    grid_b = np.vectorize(lambda d: d.process_index)(mesh_b.devices)
    assert grid_b.shape == (nprocs, ndev // nprocs)
    for r in range(nprocs):
        assert (grid_b[r] == r).all()
    # every process spans all block columns of its channel row
    assert process_block_range(spec.n, mesh_b) == (0, spec.n)

    # a DCN-crossing collective on layout B: psum over 'channels'
    from jax import lax, shard_map

    def chansum():
        i = lax.axis_index("channels")
        return lax.psum(
            jnp.full((1, 1), i + 1, jnp.int32), "channels"
        )

    tot = jax.jit(
        shard_map(
            chansum, mesh=mesh_b, in_specs=(), out_specs=P(None, None)
        )
    )()
    assert int(np.asarray(tot.addressable_shards[0].data)[0, 0]) == sum(
        range(1, nprocs + 1)
    )
    out["ok"] = True
    print("MP_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
