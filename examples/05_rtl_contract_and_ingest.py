"""Round-2 capabilities: the VHDL rounding contract on int32 lanes, raw
capture ingest through the native stream-IO runtime, and resumable
streaming.

Runs on CPU or GPU alike (force CPU with JAX_PLATFORMS=cpu).
"""
import tempfile

import _path  # noqa: F401  (in-repo import shim)
import numpy as np
import jax
import jax.numpy as jnp

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels.window import window_samples
from blackman_harris_win.model import golden
from blackman_harris_win.utils import io as sio
from blackman_harris_win.utils.streaming import StreamCursor
from blackman_harris_win.windows import catalog

# --- 1. the RTL (VHDL) rounding contract at the -180 dB config ------------
# src/bh_win_3term.vhd:257-306: product slice [2W-2:W-2], round-half-up off
# bit 0, W+2-bit alternating tree, final round off bit 1 — exactly what the
# synthesized hardware computes, bit for bit, on int32 lanes.
spec = WindowSpec(phase_width=12, data_width=32, rounding="rtl",
                  overflow="wrap")
q = catalog.get("bh7").quantized(32)
n = np.arange(0, 4096, 65, dtype=np.int32)
w_rtl = np.asarray(jax.jit(lambda x: window_samples(x, q, spec))(jnp.asarray(n)))
assert all(
    int(w_rtl[j]) == golden.win_cosine_sum_rtl(int(n[j]), q, 12, 32)
    for j in range(len(n))
)
print("RTL (VHDL) rounding contract @ W=32: bit-exact OK")

# --- 2. raw capture ingest (native mmap runtime) + streaming resume ------
with tempfile.TemporaryDirectory() as td:
    # a fake int16 capture: tone at bin 40 of a 1024-pt frame
    t = np.arange(1 << 14)
    cap = np.round(2**13 * np.cos(2 * np.pi * 40 / 1024 * t)).astype("<i2")
    path = f"{td}/capture.i16"
    cap.tofile(path)

    with sio.SampleSource(path, "i16", scale=2.0**-13) as src:
        print(f"capture: {len(src)} samples, checksum {src.checksum():#x}")
        # resumable block processing: the whole pipeline state is the
        # cursor (block index + static config) — utils/streaming.py
        cur = StreamCursor(
            spec=WindowSpec(14, 17),  # 2^14-sample stream
            coeffs_q=catalog.get("bh4").quantized(17),
            block_len=4096,
        )
        blocks = []
        while not cur.done:
            blocks.append(src.read_block(cur.next_sample, cur.block_len))
            cur = cur.advanced()
        # "crash" and resume from block 2: identical data, no other state
        resumed = src.read_block(2 * 4096, 4096)
        assert np.array_equal(resumed, blocks[2])
    print("native ingest + cursor resume: OK")

# --- 3. analyze the ingested stream with an on-the-fly quantized window ---
from blackman_harris_win.pipeline.spectral import windowed_power_spectrum

x = np.concatenate(blocks)
pxx = np.asarray(
    windowed_power_spectrum(jnp.asarray(x), "bh4", WindowSpec(10, 17))
)
assert int(np.argmax(pxx)) == 40
print(f"welch peak at bin {int(np.argmax(pxx))} (sent 40): OK")
