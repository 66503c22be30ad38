"""Boundary halo exchange over the block (sequence) axis.

The overlap-save/overlap-add stages of the spectral pipeline need the last
``halo`` samples of the *previous* time shard (frames straddle shard
boundaries).  It rides ``lax.ppermute`` (NCCL between GPUs) — the framework's
only communication primitive for the apply stage (window *generation* needs
none; SURVEY.md §5 "Long-context / sequence parallelism").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def left_halo(x, halo: int, axis_name: str, circular: bool = False):
    """Inside shard_map: the last ``halo`` samples (along the last axis) of
    the left (previous) shard; shard 0 receives zeros (stream start padding)
    unless ``circular``."""
    n = lax.axis_size(axis_name)
    tail = x[..., -halo:]
    # send my tail to my right neighbor (i -> i+1); ppermute fills
    # non-receivers with zeros
    perm = [(i, (i + 1) % n) for i in range(n if circular else n - 1)]
    return lax.ppermute(tail, axis_name, perm)


def right_halo(x, halo: int, axis_name: str, circular: bool = True):
    """Inside shard_map: the first ``halo`` samples (along the last axis) of
    the right (next) shard.  ``circular=True`` wraps the last shard around to
    shard 0 (periodic stream — uniform frame counts for Welch averaging);
    otherwise the last shard receives zeros."""
    n = lax.axis_size(axis_name)
    head = x[..., :halo]
    perm = [((i + 1) % n, i) for i in range(n if circular else n - 1)]
    return lax.ppermute(head, axis_name, perm)


def with_right_halo(x, halo: int, axis_name: str, circular: bool = True):
    """Append the right halo along the last axis: length block+halo.  The
    overlap-save framing primitive: frames starting near the end of a shard
    read into the neighbor's head."""
    if halo == 0:
        return x
    return jnp.concatenate(
        [x, right_halo(x, halo, axis_name, circular)], axis=-1
    )


def with_left_halo(x, halo: int, axis_name: str, circular: bool = False):
    """Prepend the left halo along the last axis: length halo+block.
    Equivalent to slicing the global stream [i*B - halo, (i+1)*B) with zero
    padding before sample 0."""
    if halo == 0:
        return x
    return jnp.concatenate(
        [left_halo(x, halo, axis_name, circular), x], axis=-1
    )
