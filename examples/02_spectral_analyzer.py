"""Windowed Welch spectral analysis with on-the-fly window generation.

The reference's end application: a window core feeding an FFT front-end
(SURVEY.md §1 L3).  No window table is ever stored — the quantized window
is generated inside the jitted analyzer.
"""
import _path  # noqa: F401  (in-repo import shim)
import jax
import jax.numpy as jnp
import numpy as np

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.pipeline.spectral import windowed_power_spectrum

spec = WindowSpec(phase_width=12, data_width=17)  # 4096-pt frames, BH-4
nfft = spec.n

# two tones 40 dB apart, just over a bin apart — the resolution/leakage
# test a -92 dB window exists for
fs = 1.0
t = np.arange(64 * nfft)
x = (np.sin(2 * np.pi * 0.125 * t)
     + 1e-2 * np.sin(2 * np.pi * (0.125 + 2.5 / nfft) * t)).astype(np.float32)

p = np.asarray(jax.jit(
    lambda v: windowed_power_spectrum(v, "bh4", spec, hop=nfft // 2)
)(jnp.asarray(x)))

db = 10 * np.log10(p / p.max() + 1e-300)
k0 = int(round(0.125 * nfft))
print(f"carrier bin {k0}: {db[k0]:+.1f} dB")
print(f"neighbor tone bin {k0+2}..{k0+3}: {db[k0+2]:.1f} / {db[k0+3]:.1f} dB")
far = np.r_[db[: k0 - 40], db[k0 + 44 :]]
print(f"far-field floor: {far.max():.1f} dB (window supports -92)")
assert far.max() < -60  # the weak tone resolved, leakage contained
print("spectral analyzer example: OK")
