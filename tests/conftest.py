"""Test harness config: CPU backend with an 8-device virtual mesh + int64.

Multi-device sharding is validated on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``) so sharded == single-device
can be asserted bit-for-bit without a multi-card host (SURVEY.md §4).

``JAX_PLATFORMS`` defaults to cpu here; the GPU lane
(``tests/test_gpu_lane.py``, marker ``gpu``) is run with
``JAX_PLATFORMS=cuda`` and decides in its fixture whether a card is there.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
