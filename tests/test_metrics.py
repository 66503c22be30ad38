"""Window metrology (windows/metrics.py): closed forms vs numeric DTFT,
pinned harris-table figures of merit, overlap/COLA properties, and the
quantization-impact cross-check on the reference windows."""

import math

import numpy as np
import pytest

from blackman_harris_win.windows import catalog
from blackman_harris_win.windows.metrics import (
    catalog_metrics,
    cosine_sum_coherent_gain,
    cosine_sum_enbw_bins,
    overlap_correlation,
    overlap_flatness,
    window_metrics,
)

N = 4096


def float_win(name, n=N):
    return catalog.float_window_value(name, np.arange(n), n)


class TestClosedFormVsNumeric:
    """Over a full period the cosine terms are orthogonal, so the closed
    forms must match the sampled sums to fp precision for every catalog
    window (any N > 2*K)."""

    @pytest.mark.parametrize("name", catalog.names())
    def test_enbw(self, name):
        d = catalog.get(name)
        m = window_metrics(float_win(name), n_terms=d.n_terms)
        assert m.enbw_bins == pytest.approx(
            cosine_sum_enbw_bins(d.coeffs), rel=1e-12
        )

    @pytest.mark.parametrize("name", catalog.names())
    def test_coherent_gain(self, name):
        d = catalog.get(name)
        m = window_metrics(float_win(name), n_terms=d.n_terms)
        assert m.coherent_gain == pytest.approx(
            cosine_sum_coherent_gain(d.coeffs), rel=1e-12
        )

    def test_processing_gain_is_neg_log_enbw(self):
        m = window_metrics(float_win("hann"))
        assert m.processing_gain_db == pytest.approx(
            -10 * math.log10(m.enbw_bins), abs=1e-12
        )


class TestHarrisTable:
    """Pinned figures of merit from harris 1978 (Tables on pp. 55-57) for
    the classic windows the catalog shares with the paper."""

    def test_hann(self):
        m = window_metrics(float_win("hann"), n_terms=2)
        assert m.enbw_bins == pytest.approx(1.5, abs=1e-9)
        assert m.coherent_gain == pytest.approx(0.5, abs=1e-9)
        assert m.scalloping_loss_db == pytest.approx(-1.42, abs=0.03)
        assert m.main_lobe_3db_bins == pytest.approx(1.44, abs=0.03)
        assert m.peak_sidelobe_db == pytest.approx(-31.5, abs=0.5)

    def test_bh4_min(self):
        d = catalog.get("bh4")
        m = window_metrics(float_win("bh4"), n_terms=4)
        assert m.enbw_bins == pytest.approx(2.0044, abs=2e-3)
        assert m.scalloping_loss_db == pytest.approx(-0.83, abs=0.03)
        # published floor (README.md:30-41)
        assert m.peak_sidelobe_db <= d.sidelobe_db + 1.0

    def test_worst_case_loss_composition(self):
        m = window_metrics(float_win("hamming"), n_terms=2)
        assert m.worst_case_loss_db == pytest.approx(
            m.scalloping_loss_db + m.processing_gain_db, abs=1e-12
        )
        # harris: WCL for every reasonable window is ~3-4.3 dB
        assert -4.5 < m.worst_case_loss_db < -2.9

    def test_deeper_windows_are_wider(self):
        """Monotone ENBW/main-lobe tradeoff along the BH family."""
        enbw = [
            window_metrics(float_win(n)).enbw_bins
            for n in ("hann", "bh3", "bh4", "bh5", "bh7")
        ]
        assert all(a < b for a, b in zip(enbw, enbw[1:]))

    def test_scipy_cross_check_bh4(self):
        """catalog 'bh4' is scipy's blackmanharris (periodic); the sampled
        windows and the resulting metrics must agree."""
        sw = pytest.importorskip("scipy.signal.windows")

        ours = float_win("bh4")
        theirs = sw.blackmanharris(N, sym=False)
        assert np.allclose(ours, theirs, atol=1e-12)
        a = window_metrics(ours, n_terms=4)
        b = window_metrics(theirs, n_terms=4)
        assert a.enbw_bins == pytest.approx(b.enbw_bins, rel=1e-12)
        assert a.scalloping_loss_db == pytest.approx(
            b.scalloping_loss_db, abs=1e-9
        )


class TestOverlap:
    def test_two_term_amplitude_cola_at_half(self):
        """Any 2-term cosine window is amplitude-COLA at hop=N/2 (the k=1
        harmonics of the two shifts cancel exactly)."""
        for name in ("hann", "hamming"):
            amp, _ = overlap_flatness(float_win(name), N // 2)
            assert amp == pytest.approx(1.0, abs=1e-12)

    def test_hann_power_cola_at_quarter(self):
        """hann^2 is a 3-term cosine window whose k=1,2 harmonics both
        cancel over 4 shifts of N/4 — power-COLA at 75% overlap."""
        _, pwr = overlap_flatness(float_win("hann"), N // 4)
        assert pwr == pytest.approx(1.0, abs=1e-12)

    def test_bh_windows_are_not_cola(self):
        """The >=3-term catalog windows are NOT COLA at hop=N/2 — the fact
        that forces istft's per-sample WOLA normalization."""
        for name in ("bh4", "bh7"):
            amp, _ = overlap_flatness(float_win(name), N // 2)
            assert amp < 0.99

    def test_flatness_requires_divisor_hop(self):
        with pytest.raises(ValueError):
            overlap_flatness(float_win("hann"), 1000)  # 1000 does not divide 4096

    def test_overlap_correlation_rect(self):
        """Rectangle at 50% overlap: c = 0.5 exactly."""
        assert overlap_correlation(np.ones(64), 32) == pytest.approx(0.5)

    def test_overlap_correlation_decreases_with_hop(self):
        w = float_win("bh4", 256)
        c = [overlap_correlation(w, h) for h in (32, 64, 128, 192)]
        assert all(a > b for a, b in zip(c, c[1:]))
        assert overlap_correlation(w, 0) == pytest.approx(1.0)


class TestQuantized:
    def test_quantization_preserves_merit(self):
        """W=17 BH-4 (the reference's '-92 dB needs 17 bits' sizing,
        README.md:5-6): the quantized window's scale-invariant metrics match
        float to ~1e-3 and the floor still meets the published level."""
        mf = window_metrics(float_win("bh4"), n_terms=4)
        mq = catalog_metrics(n=N, data_width=17)["bh4"]
        assert mq.enbw_bins == pytest.approx(mf.enbw_bins, rel=1e-3)
        assert mq.coherent_gain == pytest.approx(mf.coherent_gain, rel=1e-3)
        assert mq.peak_sidelobe_db <= -92.0 + 1.0

    def test_catalog_metrics_covers_catalog(self):
        out = catalog_metrics(n=1024)
        assert set(out) == set(catalog.names())
        for m in out.values():
            assert 1.0 <= m.enbw_bins < 4.2  # flattop2 is the widest, 3.85
            # flat-tops are designed for ~0 scalloping and can sit slightly
            # *above* the bin-center response at the half-bin point
            assert m.scalloping_loss_db <= 0.1


def test_interp_crossing_error():
    from blackman_harris_win.windows.metrics import _interp_crossing

    with pytest.raises(ValueError, match="never crosses"):
        _interp_crossing(np.arange(4.0), np.zeros(4), -1000.0)
