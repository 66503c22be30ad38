"""DDC + the matmul-DFT analyzer.

1. Digital downconverter: the reference's CORDIC in its titular DDS role
   (src/cordic_dds48.vhd:9-14 "sine and cosine generator") — a fixed-point
   NCO tone, an integer I/Q mixer on int32 lanes (the dds48 -sin axis
   quirk IS the downconversion phase), and a decimating windowed-sinc FIR.
2. The Welch analyzer with fft_mode="mxu": mixed-radix Cooley-Tukey whose
   small DFTs run as dense matmuls (HIGHEST precision).  Runs on CPU or
   GPU alike.
"""
import _path  # noqa: F401  (in-repo import shim)
import numpy as np
import jax
import jax.numpy as jnp

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.pipeline.ddc import ddc
from blackman_harris_win.pipeline.spectral import windowed_power_spectrum

# --- 1. DDC: recover a tone 1/256 cycles/sample above the NCO ---
fc, df, decim = 1 / 8, 1 / 256, 4
t = np.arange(8192)
x = np.cos(2 * np.pi * (fc + df) * t).astype(np.float32)
bb = np.asarray(jax.jit(lambda v: ddc(v, fc, decim))(jnp.asarray(x)))
z = (bb[0].astype(np.float64) + 1j * bb[1])[16:-16]
f_meas = np.mean(np.diff(np.unwrap(np.angle(z)))) / (2 * np.pi * decim)
print(f"DDC baseband frequency: {f_meas:.6f} cycles/input-sample "
      f"(expected {df:.6f})")
assert abs(f_meas - df) < 1e-4

# --- 2. Welch with the matmul-DFT backend vs XLA's rfft ---
spec = WindowSpec(phase_width=10, data_width=17)  # nfft = 1024
sig = (np.sin(2 * np.pi * 0.1 * np.arange(1 << 15))
       + 0.001 * np.random.default_rng(0).normal(size=1 << 15)
       ).astype(np.float32)
ps_r = np.asarray(windowed_power_spectrum(sig, "bh4", spec,
                                          fft_mode="rfft"), np.float64)
ps_m = np.asarray(windowed_power_spectrum(sig, "bh4", spec,
                                          fft_mode="mxu"), np.float64)
rel = np.max(np.abs(ps_r - ps_m) / ps_r.max())
print(f"mxu vs rfft analyzer agreement: {rel:.2e} (identical math, "
      f"f32 rounding only)")
assert rel < 2e-6
peak = int(np.argmax(ps_m))
print(f"tone bin: {peak} of {len(ps_m) - 1} (expected {round(0.1 * 1024)})")
assert peak == round(0.1 * 1024)
print("OK")
