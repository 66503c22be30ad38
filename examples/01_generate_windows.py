"""Generate quantized cosine-sum windows, all three modes.

Runs on CPU or GPU alike (small sizes; force CPU with JAX_PLATFORMS=cpu).
Mirrors the reference's simplest use: instantiate a window core, stream N
samples (src/win_selector.vhd) — here one call, any N = 2^phase_width.
"""
import _path  # noqa: F401  (in-repo import shim)
import numpy as np

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels.window import make_window
from blackman_harris_win.model import golden
from blackman_harris_win.windows import catalog

# --- bit-exact fixed-point CORDIC path (the reference's datapath) ---
spec = WindowSpec(phase_width=12, data_width=17)  # 4096-pt, -92 dB sizing
win = np.asarray(make_window("bh4", spec))
print("bh4 @17b:", win[:4], "...", f"peak {win.max()}")

# every sample equals the exact scalar golden model (transcribed from
# hls/windows/win_function.cpp)
q = catalog.get("bh4").quantized(17)
assert all(
    int(win[i]) == golden.win_cosine_sum_hls(i, q, 12, 17)
    for i in range(0, 4096, 129)
)
print("bit-exact vs golden model: OK")

# --- fast modes for the -180 dB regime (spectrally validated) ---
from blackman_harris_win.kernels.fastwin import window_values_fast
from blackman_harris_win.kernels.outerwin import window_block_outer
from blackman_harris_win.utils.spectral import window_sidelobe_db
import jax.numpy as jnp

spec7 = WindowSpec(phase_width=14, data_width=32)
q7 = catalog.get("bh7").quantized(32)
w_t2 = np.asarray(window_values_fast(jnp.arange(1 << 14), q7, spec7))
w_op = np.asarray(window_block_outer(0, (1 << 14) >> 11, q7, spec7))
for name, w in [("taylor2", w_t2), ("outer-product", w_op)]:
    print(f"{name}: measured floor {window_sidelobe_db(w, n_terms=7):.1f} dB "
          "(published -180)")
