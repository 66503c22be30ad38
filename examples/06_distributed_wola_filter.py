"""Distributed modify-in-frequency chain: sharded STFT -> notch -> sharded
WOLA istft, with frames resident on the shard that owns their samples.

Run with a virtual 8-device CPU mesh (no multi-card host needed):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORM_NAME=cpu python examples/06_distributed_wola_filter.py

The analysis frames come out of ``make_sharded_stft`` sharded
P('channels', 'blocks', None): frame m lives on the shard owning sample
m*hop, so the frequency-domain mask is a purely local elementwise multiply
— the whole chain costs exactly TWO ppermutes of nfft-hop samples each
(analysis halo + synthesis overlap-add tail), independent of mesh size.
Because the framing is circular, the WOLA inverse is exact at every sample
(closed-form periodic denominator; tests/test_stft.py::TestSharded).
"""
import _path  # noqa: F401  (in-repo import shim)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.dist.mesh import make_mesh
from blackman_harris_win.pipeline.stft import (
    make_sharded_istft,
    make_sharded_stft,
)
from blackman_harris_win.windows import catalog

ndev = len(jax.devices())
channels = 2 if ndev % 2 == 0 and ndev > 1 else 1
blocks = ndev // channels
mesh = make_mesh(blocks=blocks, channels=channels)
print(f"mesh: {mesh.shape}")

# BH-4 @ 17 bits (the reference's -92 dB sizing), 256-pt frames, 75% overlap
spec = WindowSpec(phase_width=8, data_width=17)
nfft, hop = spec.n, spec.n // 4
d = catalog.get("bh4")
q = d.quantized(spec.data_width)

fwd = jax.jit(make_sharded_stft(mesh, spec, q, d.shift, nfft, hop))
inv = jax.jit(make_sharded_istft(mesh, spec, q, d.shift, nfft, hop))

# two channels: a wanted low tone + an interferer exactly on bin 64
t = blocks * 16 * hop
n = np.arange(t)
want = np.sin(2 * np.pi * 8 / nfft * n)
jam = 0.7 * np.cos(2 * np.pi * 64 / nfft * n)
x = np.stack([want + jam] * channels).astype(np.float32)
xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("channels", "blocks")))

s = fwd(xs)
print(f"frames: {s.shape}, sharding {s.sharding.spec}")

# local elementwise notch around the interferer bin (no communication);
# wide enough to cover the BH-4 main lobe (+-4 bins) with margin — beyond
# it the window guarantees <= -92 dB leakage
mask = jnp.ones(nfft // 2 + 1).at[58:71].set(0.0)
y = inv(s * mask)

resid = np.asarray(y) - want
jam_left = float(np.sqrt(np.mean(resid**2)) / np.sqrt(np.mean(jam**2)))
print(f"interferer residual: {20*np.log10(jam_left):.1f} dB")
assert jam_left < 0.02, "notch must remove the bin-64 interferer"

# sanity: the passband is untouched (round-trip exactness of the WOLA pair)
clean = np.asarray(inv(fwd(jax.device_put(
    jnp.asarray(np.stack([want] * channels), jnp.float32),
    NamedSharding(mesh, P("channels", "blocks"))))))
print(f"passband round-trip max err: {np.abs(clean - want).max():.2e}")
assert np.abs(clean - want).max() < 2e-5
print("OK")
