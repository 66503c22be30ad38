"""Core layer: LUT constants pinned to first principles, fixed-point helpers."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from blackman_harris_win.core import fixedpoint as fp
from blackman_harris_win.core import luts


class TestLuts:
    def test_atan_pi_lut_matches_formula(self):
        # Entries are round(atan(2^-i) * 2^48/pi); the reference's stored
        # table truncates a couple of tail entries — allow 1 LSB there.
        regen = luts.regenerate_atan_lut(turn_div=1)
        for i in range(48):
            tol = 0 if i < 44 else 1
            assert abs(luts.LUT_ATAN_PI[i] - regen[i]) <= tol, i

    def test_atan_2pi_lut_matches_formula(self):
        regen = luts.regenerate_atan_lut(turn_div=2)
        for i in range(48):
            tol = 0 if i < 44 else 1
            assert abs(luts.LUT_ATAN_2PI[i] - regen[i]) <= tol, i

    def test_gain_constants(self):
        # GAIN48_HALF = (1/K)/2 * 2^48, GAIN48_QUARTER = (1/K)/4 * 2^48
        k = luts.CORDIC_GAIN
        assert abs(luts.GAIN48_HALF - (1 / k) / 2 * 2**48) < 2
        assert abs(luts.GAIN48_QUARTER - (1 / k) / 4 * 2**48) < 2
        # prod formula for K itself
        prod = 1.0
        for i in range(48):
            prod *= math.sqrt(1 + 2.0 ** (-2 * i))
        assert abs(prod - k) < 1e-12

    def test_sel_size_table(self):
        assert luts.scaled_internal_width(8) == 15
        assert luts.scaled_internal_width(16) == 30
        assert luts.scaled_internal_width(32) == 48
        with pytest.raises(ValueError):
            luts.scaled_internal_width(33)


class TestFixedPoint:
    @pytest.mark.parametrize("width", [4, 8, 12, 17, 24, 26, 31, 32])
    def test_wrap_python_int(self, width):
        lo, hi = -(1 << (width - 1)), (1 << (width - 1)) - 1
        assert fp.wrap(hi, width) == hi
        assert fp.wrap(hi + 1, width) == lo
        assert fp.wrap(lo, width) == lo
        assert fp.wrap(lo - 1, width) == hi
        assert fp.wrap(0, width) == 0
        assert fp.wrap((1 << width) + 5, width) == 5

    @pytest.mark.parametrize("width,dtype", [(26, jnp.int32), (34, jnp.int64)])
    def test_wrap_array_matches_python(self, width, dtype):
        rng = np.random.default_rng(0)
        vals = rng.integers(-(1 << (width + 2)), 1 << (width + 2), size=257)
        arr = fp.wrap(jnp.asarray(vals, dtype), width)
        expect = [fp.wrap(int(v), width) for v in vals]
        np.testing.assert_array_equal(np.asarray(arr), expect)

    def test_round_half_up(self):
        # bit0 round: 5 -> 3, 4 -> 2, -5 -> -2, -4 -> -2, -3 -> -1
        for v, want in [(5, 3), (4, 2), (-5, -2), (-4, -2), (-3, -1), (3, 2)]:
            assert fp.round_half_up_bit0(v) == want, v
        # bit1 round: 6 -> 2, 5 -> 1, -6 -> -1, -7 -> -2, -5 -> -1
        for v, want in [(6, 2), (5, 1), (-6, -1), (-7, -2), (-5, -1), (7, 2)]:
            assert fp.round_half_up_bit1(v) == want, v

    def test_round_consistent_jnp(self):
        vals = jnp.arange(-33, 33, dtype=jnp.int32)
        got0 = np.asarray(fp.round_half_up_bit0(vals))
        got1 = np.asarray(fp.round_half_up_bit1(vals))
        for i, v in enumerate(range(-33, 33)):
            assert got0[i] == fp.round_half_up_bit0(v)
            assert got1[i] == fp.round_half_up_bit1(v)

    def test_saturate(self):
        assert fp.saturate(300, 8) == 127
        assert fp.saturate(-300, 8) == -128
        assert fp.saturate(5, 8) == 5

    def test_quantize_coeff(self):
        # hls/windows/win_function.cpp:176: round(a * (2^(W-1)-1))
        assert fp.quantize_coeff(0.5, 24, 1) == round(0.5 * (2**23 - 1))
        assert fp.quantize_coeff(0.271220360585039, 32, 2) == round(
            0.271220360585039 * (2**30 - 1)
        )
