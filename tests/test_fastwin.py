"""Fast (non-bit-exact) window modes: taylor2 and the outer-product path.

Acceptance is the reference's own spectral methodology (math/window_test.m,
math/cordic_main.m:108-155; SURVEY.md §4.3): sample-domain LSB bounds vs the
ideal-rounded float window, plus the published sidelobe floor (BH-7 ->
-180 dB, README.md:30-41) measured on the padded FFT.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from blackman_harris_win.core.config import WindowSpec
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.kernels.fastwin import (
    cos_sin_taylor2,
    window_values_fast,
)
from blackman_harris_win.kernels.outerwin import window_block_outer
from blackman_harris_win.kernels.pallas.limb import mulsub_shift30
from blackman_harris_win.windows import catalog


def ideal_window(coeffs_q, pw):
    a = np.array([float(int(c)) for c in coeffs_q])
    n = np.arange(1 << pw)
    return a[0] + sum(
        (-1) ** k * a[k] * np.cos(2 * math.pi * k * n / (1 << pw))
        for k in range(1, len(a))
    )


class TestMulsubShift30:
    @pytest.mark.parametrize("shift", [30, 31])
    @pytest.mark.parametrize("round_", [False, True])
    def test_exact_vs_python_ints(self, shift, round_):
        rng = np.random.default_rng(7 + shift)
        a, c, b, d = (
            rng.integers(-(2**30) + 1, 2**30, size=4096).astype(np.int32)
            for _ in range(4)
        )
        got = np.asarray(mulsub_shift30(a, c, b, d, round=round_, shift=shift))
        v = a.astype(object) * c.astype(object) - b.astype(object) * d.astype(
            object
        )
        bias = 1 << (shift - 1) if round_ else 0
        want = np.array([(int(x) + bias) >> shift for x in v], dtype=object)
        # only results fitting int32 are in-contract
        ok = np.abs(want.astype(np.float64)) < 2**31
        np.testing.assert_array_equal(got[ok].astype(object), want[ok])


class TestTaylor2:
    @pytest.mark.parametrize("w", [20, 24, 32])
    def test_cos_sin_accuracy(self, w):
        pw, ls = 16, 12
        p = np.arange(0, 1 << pw, 3, dtype=np.int32)
        c, s = jax.jit(lambda p: cos_sin_taylor2(p, pw, w, ls))(p)
        amp = 2.0 ** (w - 2) - 1
        ang = p * (2 * math.pi / (1 << pw))
        ic = np.floor(amp * np.cos(ang) + 0.5)
        isn = np.floor(amp * np.sin(ang) + 0.5)
        assert np.abs(np.asarray(c, np.float64) - ic).max() <= 3
        assert np.abs(np.asarray(s, np.float64) - isn).max() <= 3

    def test_pure_lut_regime_is_exactly_rounded(self):
        # pw - 2 <= lut_size: no interpolation -> exact ideal rounding,
        # the tb_windows "exact reference instance" idea
        # (src/tb/tb_windows.vhd:320-333).
        pw, w, ls = 12, 24, 12
        p = np.arange(1 << pw, dtype=np.int32)
        c, s = jax.jit(lambda p: cos_sin_taylor2(p, pw, w, ls))(p)
        amp = 2.0 ** (w - 2) - 1
        ang = p * (2 * math.pi / (1 << pw))
        np.testing.assert_array_equal(
            np.asarray(c, np.float64), np.floor(amp * np.cos(ang) + 0.5)
        )
        np.testing.assert_array_equal(
            np.asarray(s, np.float64), np.floor(amp * np.sin(ang) + 0.5)
        )

    def test_quadrant_seams(self):
        pw, w, ls = 20, 32, 12
        N = 1 << pw
        seams = []
        for q in (0, N // 4, N // 2, 3 * N // 4):
            seams += [q - 1, q, q + 1]
        p = np.array(seams, dtype=np.int32) % N
        c, s = cos_sin_taylor2(p, pw, w, ls)
        amp = 2.0 ** (w - 2) - 1
        ang = p * (2 * math.pi / N)
        assert np.abs(np.asarray(c, np.float64) - np.floor(amp * np.cos(ang) + 0.5)).max() <= 3
        assert np.abs(np.asarray(s, np.float64) - np.floor(amp * np.sin(ang) + 0.5)).max() <= 3

    def test_window_dispatch_and_floor(self):
        pw, w = 16, 32
        spec = WindowSpec(pw, w, sin_type="taylor2", lut_size=12, overflow="wrap")
        q = catalog.get("bh7").quantized(w)
        n = np.arange(1 << pw, dtype=np.int32)
        via_dispatch = np.asarray(kw.window_samples(n, q, spec), np.float64)
        direct = np.asarray(window_values_fast(n, q, spec), np.float64)
        np.testing.assert_array_equal(via_dispatch, direct)
        assert np.abs(via_dispatch - ideal_window(q, pw)).max() <= 8
        assert _sidelobe_db(via_dispatch, 7) <= -180.0


def _sidelobe_db(win, n_terms):
    n = len(win)
    m = 4 * n
    sp = np.abs(np.fft.fft(win, m))
    db = 20 * np.log10(sp / sp.max() + 1e-300)
    guard = 4 * 16 * n_terms
    side = np.concatenate([db[guard : m // 2], db[m // 2 : m - guard]])
    return float(side.max())


class TestOuterProduct:
    def test_matches_ideal_within_lsb(self):
        pw, w = 16, 32
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get("bh7").quantized(w)
        win = np.asarray(
            jax.jit(lambda n0: window_block_outer(n0, (1 << pw) >> 11, q, spec))(0),
            np.float64,
        )
        err = win - ideal_window(q, pw)
        assert np.abs(err).max() <= 6
        assert abs(err.mean()) < 0.1  # round-half-up keeps it centered

    def test_bh7_holds_published_floor(self):
        pw, w = 16, 32
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get("bh7").quantized(w)
        win = np.asarray(window_block_outer(0, (1 << pw) >> 11, q, spec), np.float64)
        assert _sidelobe_db(win, 7) <= -180.0

    def test_blocks_tile_the_window(self):
        # generating per-block (the streaming/sharded pattern) must equal
        # one-shot generation: closed-form phases, no carried state
        pw, w, m = 15, 32, 8
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get("bh5").quantized(w)
        full = np.asarray(window_block_outer(0, (1 << pw) >> m, q, spec, m=m))
        rows_per_blk = (1 << pw) >> (m + 2)
        blocks = [
            np.asarray(
                window_block_outer(i * rows_per_blk * (1 << m), rows_per_blk, q, spec, m=m)
            )
            for i in range(4)
        ]
        np.testing.assert_array_equal(np.concatenate(blocks), full)

    @pytest.mark.parametrize("name,w,bound", [
        ("bh4", 18, -91.0),
        ("bh5", 24, -123.0),
        ("hann", 17, -31.0),
    ])
    def test_other_windows_hold_published_floor(self, name, w, bound):
        pw = 13
        spec = WindowSpec(pw, w, overflow="saturate")
        q = catalog.get(name).quantized(w)
        win = np.asarray(window_block_outer(0, (1 << pw) >> 11, q, spec), np.float64)
        k = catalog.get(name).n_terms
        assert _sidelobe_db(win, k) <= bound

    def test_traced_offset(self):
        # n0 may be a traced scalar (scan over blocks)
        pw, w = 14, 32
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get("bh7").quantized(w)

        @jax.jit
        def gen(n0):
            return window_block_outer(n0, 2, q, spec)

        got = np.asarray(gen(jnp.int32(4096)))
        want = np.asarray(window_block_outer(4096, 2, q, spec))
        np.testing.assert_array_equal(got, want)
