"""Host-side sample ingest: raw capture files -> framed f32 blocks.

ctypes bridge to the native stream-IO runtime (``native/stream_io.cpp``):
mmap'd zero-copy sources with tight C++ conversion loops, random block
access (the resumable streaming contract of ``utils/streaming.py`` — state
is a block index), and the raw little-endian formats the reference's own
tool handoffs use (``hls/windows/window_test.cpp:54-56``,
``cpp/cordic_sincos.cpp:131`` write .dat sample files).

Formats: ``i8`` / ``i16`` (real), ``f32`` (real), ``ci16`` (interleaved
IQ pairs -> complex64).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libstreamio.so"
_lib = None

#: format -> (bytes per sample, numpy output dtype)
FORMATS = {
    "i8": (1, np.float32),
    "i16": (2, np.float32),
    "f32": (4, np.float32),
    "ci16": (4, np.complex64),
}


def build(force: bool = False) -> pathlib.Path:
    """Bring native/libstreamio.so up to date with its source: ``make`` rebuilds
    only when the .cpp is newer (``force`` rebuilds anyway)."""
    subprocess.run(
        ["make", "-C", str(_NATIVE_DIR), _LIB_PATH.name]
        + (["-B"] if force else []),
        check=True,
        capture_output=True,
    )
    return _LIB_PATH


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(_LIB_PATH))
        _lib.sio_open.restype = ctypes.c_void_p
        _lib.sio_open.argtypes = [ctypes.c_char_p]
        _lib.sio_size_bytes.restype = ctypes.c_int64
        _lib.sio_size_bytes.argtypes = [ctypes.c_void_p]
        _lib.sio_close.argtypes = [ctypes.c_void_p]
        fptr = ctypes.POINTER(ctypes.c_float)
        for name in ("sio_read_i8_f32", "sio_read_i16_f32", "sio_read_f32"):
            fn = getattr(_lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_float, fptr]
        _lib.sio_read_ci16_f32.restype = ctypes.c_int64
        _lib.sio_read_ci16_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            fptr, fptr,
        ]
        _lib.sio_checksum.restype = ctypes.c_uint64
        _lib.sio_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64]
        _lib.sio_write_i32.restype = ctypes.c_int64
        _lib.sio_write_i32.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int32),
                                       ctypes.c_int64]
    return _lib


class SampleSource:
    """mmap'd raw sample file with random block access.

    >>> src = SampleSource("capture.i16", fmt="i16", scale=2**-15)
    >>> block = src.read_block(offset_samples, count)   # float32 (count,)
    """

    def __init__(self, path, fmt: str = "i16", scale: float = 1.0):
        if fmt not in FORMATS:
            raise ValueError(f"fmt must be one of {sorted(FORMATS)}")
        self._lib = lib()
        self._h = self._lib.sio_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open (or empty) sample file: {path}")
        self.fmt = fmt
        self.scale = float(scale)
        self.path = str(path)

    def __len__(self) -> int:
        bps, _ = FORMATS[self.fmt]
        return self._lib.sio_size_bytes(self._h) // bps

    def read_block(self, offset: int, count: int) -> np.ndarray:
        """Samples [offset, offset+count) as float32 (complex64 for ci16);
        clamped at end-of-file (returned array may be shorter)."""
        fptr = ctypes.POINTER(ctypes.c_float)
        if self.fmt == "ci16":
            i = np.empty(count, np.float32)
            q = np.empty(count, np.float32)
            n = self._lib.sio_read_ci16_f32(
                self._h, offset, count, self.scale,
                i.ctypes.data_as(fptr), q.ctypes.data_as(fptr),
            )
            return (i[:n] + 1j * q[:n]).astype(np.complex64)
        out = np.empty(count, np.float32)
        fn = {
            "i8": self._lib.sio_read_i8_f32,
            "i16": self._lib.sio_read_i16_f32,
            "f32": self._lib.sio_read_f32,
        }[self.fmt]
        n = fn(self._h, offset, count, self.scale, out.ctypes.data_as(fptr))
        return out[:n]

    def checksum(self, byte_off: int = 0, nbytes: int | None = None) -> int:
        """FNV-1a over raw bytes — resume-integrity fingerprint."""
        if nbytes is None:
            bps, _ = FORMATS[self.fmt]
            nbytes = len(self) * bps - byte_off
        return int(self._lib.sio_checksum(self._h, byte_off, nbytes))

    def close(self):
        if self._h:
            self._lib.sio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_i32(path, data) -> int:
    """Write int32 samples as raw little-endian (the .dat handoff format)."""
    arr = np.ascontiguousarray(np.asarray(data, np.int32))
    n = lib().sio_write_i32(
        str(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arr.size,
    )
    if n != arr.size:
        raise OSError(f"short write to {path}")
    return int(n)
