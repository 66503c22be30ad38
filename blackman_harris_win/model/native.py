"""ctypes bridge to the native golden-model library (native/golden.cpp).

The C++ library is the framework's independent bit-exact oracle (the
counterpart of the reference's cpp/ and hls/ model layer).  It is built on
first use with the in-tree Makefile (g++; no pip packages involved) and loaded
via ctypes.  All bulk entry points take/return int64 arrays.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgolden.so"
_lib = None


def build(force: bool = False) -> pathlib.Path:
    """Bring native/libgolden.so up to date with its source: ``make`` rebuilds
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
    return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def cordic_hls(n, pw: int, w: int):
    n = _i64(n)
    c = np.empty_like(n)
    s = np.empty_like(n)
    lib().cordic_hls_bulk(_ptr(n), len(n), pw, w, _ptr(c), _ptr(s))
    return c, s


def cordic_dds(n, pw: int, w: int, p: int = 1):
    n = _i64(n)
    c = np.empty_like(n)
    s = np.empty_like(n)
    lib().cordic_dds_bulk(_ptr(n), len(n), pw, w, p, _ptr(c), _ptr(s))
    return c, s


def cordic_dds48(n, pw: int, w: int):
    n = _i64(n)
    c = np.empty_like(n)
    s = np.empty_like(n)
    lib().cordic_dds48_bulk(_ptr(n), len(n), pw, w, _ptr(c), _ptr(s))
    return c, s


def cordic_scaled(n, pw: int, w: int):
    n = _i64(n)
    c = np.empty_like(n)
    s = np.empty_like(n)
    lib().cordic_scaled_bulk(_ptr(n), len(n), pw, w, _ptr(c), _ptr(s))
    return c, s


def cordic_atan2(y, x, iw_in: int, aw: int, p: int = 1):
    y, x = _i64(y), _i64(x)
    out = np.empty_like(y)
    lib().atan2_bulk(_ptr(y), _ptr(x), len(y), iw_in, aw, p, _ptr(out))
    return out


def taylor_sincos(n, pw: int, w: int, ls: int):
    n = _i64(n)
    c = np.empty_like(n)
    s = np.empty_like(n)
    lib().taylor_bulk(_ptr(n), len(n), pw, w, ls, _ptr(c), _ptr(s))
    return c, s


def win_rtl(n, coeffs_q, pw: int, w: int, p: int = 1):
    n = _i64(n)
    coeffs = _i64(coeffs_q)
    out = np.empty_like(n)
    lib().win_rtl_bulk(
        _ptr(n), len(n), _ptr(coeffs), len(coeffs), pw, w, p, _ptr(out)
    )
    return out


def win_hls(n, coeffs_q, pw: int, w: int):
    n = _i64(n)
    coeffs = _i64(coeffs_q)
    out = np.empty_like(n)
    lib().win_hls_bulk(_ptr(n), len(n), _ptr(coeffs), len(coeffs), pw, w, _ptr(out))
    return out
