"""Device mesh helpers.

The reference is a single-chip streaming design with no interconnect
(SURVEY.md §5: deepest "interconnect" is the DSP48 PCIN cascade).  This
framework's distribution axes are new design, constrained only by the
bit-exactness contracts.  The cards of one GPU host are joined all to all,
so the mesh follows the algorithm alone:

- ``blocks``: time/sequence sharding of the sample axis (SP/CP-like).  Window
  generation shards with *zero communication* because phases are closed-form
  ``(k*n) mod 2^PHI`` (src/bh_win_3term.vhd:159-172); the overlap-save apply
  stage needs only boundary halos (ppermute).
- ``channels``: independent streams (DP-like), e.g. channelizer outputs.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(blocks: int = 1, channels: int = 1, devices=None) -> Mesh:
    """Build a (channels, blocks) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    need = blocks * channels
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(channels, blocks)
    return Mesh(dev, axis_names=("channels", "blocks"))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """1-D sharding of a sample axis over the 'blocks' mesh axis."""
    return NamedSharding(mesh, P("blocks"))
