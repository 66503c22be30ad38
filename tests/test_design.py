"""Window design LP (windows/design.py): regenerating the reference's
published minimum-sidelobe family from first principles, custom trade-offs,
null placement, and the handoff into the quantized generation path."""

import numpy as np
import pytest

from blackman_harris_win.windows import catalog
from blackman_harris_win.windows.design import (
    DesignResult,
    cosine_sum_spectrum,
    design_min_sidelobe,
    quantized_coeffs,
    sampled_window,
)
from blackman_harris_win.windows.metrics import window_metrics

pytest.importorskip("scipy.optimize")


class TestSpectrumModel:
    def test_peak_is_a0(self):
        d = catalog.get("bh4")
        assert cosine_sum_spectrum(d.coeffs, 0.0)[0] == pytest.approx(
            d.coeffs[0]
        )

    def test_matches_fft_of_sampled_window(self):
        """The large-N sinc model agrees with the actual zero-padded FFT of
        the N=4096 window away from the main lobe.  Compared in magnitude:
        the sampled (n=0-origin) window carries linear phase
        e^{-i pi f (N-1)/N} that the centered-window model omits."""
        d = catalog.get("bh4")
        n, os = 4096, 16
        w = catalog.float_window_value("bh4", np.arange(n), n)
        spec = np.fft.rfft(w, os * n) / n
        f = np.asarray([4.5, 6.25, 10.0, 20.5])
        model = cosine_sum_spectrum(d.coeffs, f)
        fftv = np.abs(spec[(f * os).astype(int)])
        assert np.allclose(np.abs(model), fftv, atol=3e-7)


class TestReproducesCatalog:
    def test_two_term_is_the_hamming_optimum(self):
        """K=2, stop at 2 bins: the -43.2 dB equiripple optimum, the textbook
        Hamming a0 = 0.53836.  (The catalog's 'hamming' entry carries the
        'exact Hamming' 25/46 = 0.5435, which zeros one specific sidelobe
        instead of equalizing them all — ~5e-3 away from the optimum.)"""
        r = design_min_sidelobe(2)
        assert r.sidelobe_db < -43.0
        assert r.coeffs[0] == pytest.approx(0.53836, abs=1e-3)
        assert r.coeffs[0] == pytest.approx(
            catalog.get("hamming").coeffs[0], abs=6e-3
        )

    def test_four_term_is_the_minimum_sidelobe_set(self):
        """K=4: the LP lands on the true minimax optimum — Nuttall's -98 dB
        'minimum 4-term' set, the catalog's blackman_nuttall entry
        (src/bh_win_4term.vhd:12-19) — reproduced to ~1e-5.  Harris' BH-4
        (-92 dB, README.md:30-41) is a near-optimal variant of the same
        problem, strictly dominated by this solution."""
        r = design_min_sidelobe(4)
        bn = catalog.get("blackman_nuttall")
        assert r.sidelobe_db < -97.0
        assert np.allclose(r.coeffs, bn.coeffs, atol=1e-4)
        # ... and it dominates the published BH-4 floor
        assert r.sidelobe_db < catalog.get("bh4").sidelobe_db
        # measured on the sampled window, the floor holds
        m = window_metrics(sampled_window(r, 4096), n_terms=4)
        assert m.peak_sidelobe_db < -97.0

    def test_seven_term_hits_minus_180(self):
        """K=7: far beyond the -180 dB class — the unconstrained 7-term
        minimax optimum is ~-253 dB (the reference's bh7 set trades floor
        for main-lobe width; both satisfy the -180 headline)."""
        r = design_min_sidelobe(7)
        assert r.sidelobe_db < -180.0
        m = window_metrics(sampled_window(r, 8192), n_terms=7)
        assert m.peak_sidelobe_db < -170.0

    def test_normalization_is_unit_time_peak(self):
        r = design_min_sidelobe(5)
        assert sum(r.coeffs) == pytest.approx(1.0, abs=1e-9)
        w = sampled_window(r, 1024)
        assert w[512] == pytest.approx(1.0, abs=1e-9)


class TestTradeoffsAndNulls:
    def test_wider_stopband_buys_floor(self):
        """Pushing the stop edge out trades main-lobe width for depth."""
        narrow = design_min_sidelobe(4, stop_bin=3.0)
        default = design_min_sidelobe(4)
        wide = design_min_sidelobe(4, stop_bin=5.0)
        assert narrow.sidelobe_db > default.sidelobe_db > wide.sidelobe_db

    def test_prescribed_null(self):
        """W(f0) = 0 exactly at a prescribed interferer offset."""
        f0 = 9.5
        r = design_min_sidelobe(4, nulls=(f0,))
        assert abs(cosine_sum_spectrum(r.coeffs, f0)[0]) < 1e-12
        # still a deep window (one ripple spent on the null)
        assert r.sidelobe_db < -80.0

    def test_bad_args(self):
        with pytest.raises(ValueError, match="at least 2"):
            design_min_sidelobe(1)
        with pytest.raises(ValueError, match="stop_bin"):
            design_min_sidelobe(4, stop_bin=0.5)


class TestQuantizedHandoff:
    def test_designed_window_through_the_generation_path(self):
        """Designed coefficients quantize and generate through the same
        fixed-point kernel as the catalog (bit-exact vs the golden scalar
        model), and the quantized floor matches the design's promise at the
        width the 6 dB/bit rule predicts."""
        import jax.numpy as jnp

        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.kernels.window import window_samples
        from blackman_harris_win.model import golden
        from blackman_harris_win.utils.spectral import (
            required_width_for_sidelobe,
            window_sidelobe_db,
        )

        r = design_min_sidelobe(4)
        width = required_width_for_sidelobe(r.sidelobe_db)  # -98 dB -> 18
        assert width == 18
        q = quantized_coeffs(r, width)
        spec = WindowSpec(phase_width=12, data_width=width)
        w = np.asarray(
            window_samples(jnp.arange(4096, dtype=jnp.int32), q, spec)
        )
        for i in (0, 1, 1024, 2048, 3072, 4095):
            assert int(w[i]) == golden.win_cosine_sum_hls(i, q, 12, width)
        assert window_sidelobe_db(w.astype(float), n_terms=4) < -95.0

    def test_designed_7term_full_depth_w32(self):
        """VERDICT r3 item 8: the designed 7-term set (-253 dB LP optimum)
        through the flagship bit-exact HLS contract at full W=32 depth with
        shift-1 (31-magnitude-bit) packing.  Measured floor: -181.5 dB —
        past the catalog BH-7's -180.06 through the same datapath, and past
        the reference's -180 headline.  The 6 dB/bit coefficient bound
        (-186) is NOT reached: the W=32 CORDIC's few-LSB approximation
        error (mean < 10 LSB acceptance, SURVEY §4.1) sits at ~2^-30
        relative and sets a ~-181 dB datapath noise floor — coefficient
        quantization stopped being the binding limit at shift 2 already."""
        import jax.numpy as jnp

        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.kernels.window import window_samples
        from blackman_harris_win.utils.spectral import window_sidelobe_db

        r = design_min_sidelobe(7)
        q1 = quantized_coeffs(r, 32, shift=1)
        # shift-1 packs one extra magnitude bit vs the catalog rule
        assert max(q1) > (1 << 29)
        pw = 13
        w = {}
        for ov in ("wrap", "saturate"):
            spec = WindowSpec(pw, 32, rounding="hls", overflow=ov)
            w[ov] = np.asarray(window_samples(
                jnp.arange(1 << pw, dtype=jnp.int32), q1, spec
            )).astype(np.float64)
        # the exact-peak a0 trim makes wrap safe: peak is exactly full scale
        # and the saturate variant is identical
        assert w["wrap"].max() == float((1 << 31) - 1)
        np.testing.assert_array_equal(w["wrap"], w["saturate"])
        fl = window_sidelobe_db(w["wrap"], n_terms=7)
        assert fl <= -181.0  # measured -181.54
        assert fl > -186.0  # CORDIC-noise-limited below the 6 dB/bit bound

    def test_designed_7term_rtl_corrected_w32(self):
        """The same designed set through the RTL (VHDL) rounding contract
        with the corrected CORDIC-source ports (AA0 halved,
        kernels/window.rtl_cordic_coeffs): floor -179.8 — the RTL b_k
        W-bit product round costs ~2 dB vs the HLS path."""
        import jax.numpy as jnp

        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.kernels.window import (
            rtl_cordic_coeffs,
            window_samples,
        )
        from blackman_harris_win.utils.spectral import window_sidelobe_db

        r = design_min_sidelobe(7)
        qr = rtl_cordic_coeffs(quantized_coeffs(r, 32, shift=1))
        spec = WindowSpec(13, 32, rounding="rtl", overflow="wrap")
        w = np.asarray(window_samples(
            jnp.arange(1 << 13, dtype=jnp.int32), qr, spec
        )).astype(np.float64)
        assert window_sidelobe_db(w, n_terms=7) <= -179.0  # measured -179.77

    def test_suggest_shift_follows_catalog_pattern(self):
        """Catalog rule (hls win_function.cpp:176,349): shift 1 for 2..4-term
        (hamming's a0=0.5435 included), 2 for 5+-term."""
        assert design_min_sidelobe(4).suggest_shift() == 1  # bh4: shift 1
        assert design_min_sidelobe(7).suggest_shift() == 2  # bh7: shift 2
        assert design_min_sidelobe(2).suggest_shift() == 1  # hamming: shift 1
        assert design_min_sidelobe(5).suggest_shift() == 2  # bh5: shift 2
        # 3-term with a coefficient > 0.5 still follows the term-count rule
        assert DesignResult((0.25, 0.55, 0.2), -60.0, 3.0).suggest_shift() == 1
        # unless a coefficient can't fit Q0.(W-1) at all
        assert DesignResult((1.1, -0.2, 0.1), -20.0, 3.0).suggest_shift() == 2


class TestQuantizedShiftValidation:
    def test_explicit_shift_zero_rejected(self):
        """shift=0 must raise, not silently fall back to the catalog rule
        (the old `shift or suggest_shift()` treated 0 as falsy)."""
        from blackman_harris_win.windows.design import (
            design_min_sidelobe, quantized_coeffs,
        )

        r = design_min_sidelobe(4)
        with pytest.raises(ValueError, match="shift"):
            quantized_coeffs(r, 17, shift=0)
        # None still means "use the catalog rule"
        q_none = quantized_coeffs(r, 17, shift=None)
        q_rule = quantized_coeffs(r, 17, shift=r.suggest_shift())
        assert q_none == q_rule
