"""Multi-host initialization and mesh layout.

The reference has no distributed anything (single FPGA); this is the
communication design (SURVEY.md §5): ``jax.distributed`` brings up the
process group, the mesh lays 'blocks' (sequence) within a host and
'channels' across hosts — window *generation* needs no communication at
all, the analyzer's halos stay on the host's interconnect, and only the
Welch psum crosses hosts.

On one GPU host, one process drives all of its local cards and needs no
``initialize`` at all (``dist.mesh.make_mesh`` over ``jax.devices()``).
Across hosts, run one process per host::

    from blackman_harris_win.dist import multihost
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=2, process_id=rank)
    mesh = multihost.pod_mesh(channels=...)

This module is validated here via its single-process degenerate path, the
virtual-device mesh and a 2-process CPU bring-up; the sharded steps
themselves are hardware-agnostic shard_maps tested on the 8-device virtual
mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(**kwargs) -> None:
    """Bring up jax.distributed (idempotent).  Pass coordinator_address/
    num_processes/process_id explicitly (the simulated 2-process CPU
    bring-up in tests/test_multiprocess.py does exactly that); with no
    arguments only environments that advertise a cluster auto-detect.

    A failed *explicit* multi-process bring-up raises — silently degrading
    to single-process would run every collective on a fraction of the data.
    Only the auto-detect path may fall back (single host, no coordinator).

    The idempotency check is ``jax.distributed.is_initialized()``, NOT
    ``jax.process_count()``: the latter initializes the XLA backend, after
    which ``jax.distributed.initialize`` refuses to run at all."""
    if jax.distributed.is_initialized() or getattr(initialize, "_done", False):
        return
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        if int(kwargs.get("num_processes") or 1) > 1:
            raise
        # single-process (already initialized or no coordinator): fine
        pass
    initialize._done = True


def pod_mesh(channels: int = 1, blocks: int | None = None) -> Mesh:
    """(channels, blocks) mesh over all global devices, laid out so the
    'blocks' axis stays within hosts (halo traffic on the host's
    interconnect) and 'channels' spans hosts (no halo traffic).

    Device order from jax.devices() groups by process; reshaping
    (channels, blocks) with channels as the slow axis therefore puts
    consecutive block shards on intra-host neighbors.
    """
    devs = jax.devices()
    total = len(devs)
    if blocks is None:
        if total % channels:
            raise ValueError(f"{total} devices not divisible by {channels}")
        blocks = total // channels
    if channels * blocks != total:
        raise ValueError(
            f"mesh {channels}x{blocks} != {total} global devices"
        )
    arr = np.asarray(devs).reshape(channels, blocks)
    return Mesh(arr, axis_names=("channels", "blocks"))


def owned_block_cols(process_grid: np.ndarray, pid: int) -> tuple[int, int]:
    """[first, last+1) block columns owned by process ``pid`` given the
    (channels, blocks) grid of device process indices.  A host owning
    devices only on non-zero channel rows still feeds the block columns
    those devices sit at.  Pure function (testable without pod hardware);
    returns (0, 0) when the process owns no device in the mesh."""
    cols = sorted(
        {int(j) for _i, j in zip(*np.where(process_grid == pid))}
    )
    if not cols:
        return (0, 0)
    return (cols[0], cols[-1] + 1)


def process_block_range(n_total: int, mesh: Mesh) -> tuple[int, int]:
    """The [start, end) sample range this host's shards own along 'blocks' —
    for feeding per-host input pipelines without a global gather."""
    nblocks = mesh.shape["blocks"]
    per = n_total // nblocks
    grid = np.vectorize(lambda d: d.process_index)(
        mesh.devices.reshape(-1, nblocks)
    )
    lo, hi = owned_block_cols(grid, jax.process_index())
    return (lo * per, hi * per)
