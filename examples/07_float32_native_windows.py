"""Native float32 window generation — the fast path for float consumers.

The reference is an integer IP library; its consumers are integer FFT
cores.  Here the downstream consumers (Welch, STFT, WOLA) are float32,
so this framework adds a mode the reference cannot have: generate the
window *natively* in f32 (``kernels/floatwin.py``, ~4 f32 ops per
harmonic per sample, no int datapath, no convert pass).  Measured: the
f32 floor equals the f64 floor for every catalog window through 5 terms;
BH-7 holds ~-163 dB of its -180 dB contract (the exact int paths keep the
rest).
"""
import _path  # noqa: F401  (in-repo import shim)
import jax
import jax.numpy as jnp
import numpy as np

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels.floatwin import float_window
from blackman_harris_win.pipeline.spectral import windowed_power_spectrum
from blackman_harris_win.pipeline.stft import float_stft_pair
from blackman_harris_win.utils.spectral import window_sidelobe_db

# 1. the window itself: f32, unit amplitude, floor measured spectrally
w = np.asarray(jax.jit(lambda: float_window("bh5", 14))())
floor = window_sidelobe_db(w.astype(np.float64))
print(f"bh5 f32 floor: {floor:.1f} dB (published -124)")
assert floor <= -124.0  # f32 == f64 floor through 5-term windows

# 2. Welch analysis in float mode — the window never exists as integers
spec = WindowSpec(phase_width=10, data_width=17)
rng = np.random.default_rng(0)
x = jnp.asarray(rng.normal(size=(4 * spec.n,)).astype(np.float32))
p = np.asarray(jax.jit(
    lambda v: windowed_power_spectrum(v, "bh4", spec, win_mode="float")
)(x))
assert p.shape == (spec.n // 2 + 1,) and np.isfinite(p).all()
print(f"float-mode Welch: {p.shape[0]} bins, total power {p.sum():.3f}")

# 3. STFT/WOLA round trip over the float window
fwd, inv, win = float_stft_pair("bh4", 8, hop=128)
y = np.asarray(inv(fwd(x[: 4 * 256]), length=4 * 256))
err = np.max(np.abs(y[256:-256] - np.asarray(x[: 4 * 256])[256:-256]))
print(f"WOLA interior reconstruction error: {err:.2e}")
assert err < 1e-4
print("float32 native windows example: OK")

# 4. the compensated-f32 mode (round 4): the FULL -180 dB BH-7 contract in
# the float regime.  Pure f32 output cannot hold it (rounding the exact
# window to f32 already floors at -178.6 dB at pw=16) — the (hi, lo) pair
# can, applied as x*hi + x*lo.
from blackman_harris_win.kernels.compwin import comp_window

hi, lo = comp_window("bh7", 16, pair=True)
pair = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
floor_pair = window_sidelobe_db(pair, n_terms=7)
floor_hi = window_sidelobe_db(np.asarray(hi, np.float64), n_terms=7)
print(f"bh7 comp pair floor: {floor_pair:.1f} dB (contract -180; "
      f"folded-f32 alone: {floor_hi:.1f} = the f32 format bound)")
assert floor_pair <= -180.0

# Welch with the pair window (frames see the window at ~2^-31 accuracy)
p_c = np.asarray(jax.jit(
    lambda v: windowed_power_spectrum(v, "bh4", spec, win_mode="comp")
)(x))
assert p_c.shape == p.shape and np.isfinite(p_c).all()
print("comp-mode Welch agrees with float mode to "
      f"{np.max(np.abs(p_c - p) / (np.abs(p) + 1e-12)):.1e} relative")
print("compensated-f32 example: OK")
