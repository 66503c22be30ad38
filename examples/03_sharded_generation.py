"""Sharded window generation + sharded Welch over a device mesh.

Run with a virtual 8-device CPU mesh (no multi-card host needed):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORM_NAME=cpu python examples/03_sharded_generation.py

Window phases are closed-form ((k*n) mod 2^PHI), so every shard generates
its slice with ZERO communication — no host ever materializes the window
(the reference's defining feature, README.md:2-3, scaled out).  The Welch
analyzer exchanges only frame halos (ppermute) and one psum.
"""
import _path  # noqa: F401  (in-repo import shim)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.dist.generate import sharded_window
from blackman_harris_win.dist.mesh import make_mesh
from blackman_harris_win.pipeline.spectral import make_sharded_welch
from blackman_harris_win.windows import catalog

ndev = len(jax.devices())
channels = 2 if ndev % 2 == 0 and ndev > 1 else 1
mesh = make_mesh(blocks=ndev // channels, channels=channels)
print(f"mesh: {mesh.shape}")

# --- communication-free sharded generation (here 2^18; same code at 2^26) ---
spec = WindowSpec(phase_width=18, data_width=32)
w = sharded_window(catalog.get("bh7").quantized(32), spec, mesh, axis="blocks")
print(f"sharded window: {w.shape}, sharding {w.sharding}")

# --- sharded Welch: window gen per shard + ppermute halo + psum average ---
aspec = WindowSpec(phase_width=10, data_width=17)
bh4 = catalog.get("bh4")
step = jax.jit(make_sharded_welch(mesh, aspec, bh4.quantized(17), bh4.shift,
                                  nfft=1024, hop=512))
x = np.random.default_rng(0).normal(
    size=(2 * channels, (ndev // channels) * 4096)).astype(np.float32)
xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks")))
p = step(xs)
print(f"spectrum: {p.shape} (sharded {p.sharding})")

# sharded == single-device, bit-for-bit on the quantized window
w1 = np.asarray(w)
from blackman_harris_win.kernels.window import make_window
w0 = np.asarray(make_window("bh7", spec))
assert (w0 == w1).all()
print("sharded == single-device: bit-exact OK")
