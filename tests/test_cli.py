"""CLI front-end (``python -m blackman_harris_win``) tests — CPU."""

import json

import numpy as np
import pytest

from blackman_harris_win.__main__ import main
from blackman_harris_win.model import golden
from blackman_harris_win.windows import catalog


def test_list_json(capsys):
    assert main(["list", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert {r["name"] for r in rows} == set(catalog.names())
    bh7 = next(r for r in rows if r["name"] == "bh7")
    assert bh7["terms"] == 7 and bh7["sidelobe_db"] == -180.0


def test_info_quantized(capsys):
    assert main(["info", "bh4", "--data-width", "17"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert tuple(out["quantized"]) == catalog.get("bh4").quantized(17)
    assert out["required_width"] == 17  # -92 dB => 16+1 bits (README.md:5-6)


def test_gen_exact_bit_exact(tmp_path):
    f = tmp_path / "w.npy"
    assert main([
        "gen", "hamming", "--phase-width", "10", "--data-width", "16",
        "--overflow", "wrap", "--out", str(f),
    ]) == 0
    w = np.load(f)
    q = catalog.get("hamming").quantized(16)
    assert len(w) == 1024
    for i in (0, 1, 511, 512, 1023):
        assert int(w[i]) == golden.win_cosine_sum_hls(i, q, 10, 16)


@pytest.mark.parametrize("mode", ["taylor2", "outer"])
def test_gen_fast_modes(tmp_path, mode, capsys):
    f = tmp_path / "w.npy"
    assert main([
        "gen", "bh7", "--phase-width", "12", "--data-width", "32",
        "--mode", mode, "--out", str(f), "--measure-floor",
    ]) == 0
    w = np.load(f).astype(np.float64)
    err = capsys.readouterr().err
    floor = json.loads(err.splitlines()[-1])["measured_sidelobe_db"]
    assert floor <= -179.0
    assert w.max() <= 2**30 and len(w) == 4096


def test_gen_float_mode(tmp_path, capsys):
    f = tmp_path / "w.npy"
    assert main([
        "gen", "bh7", "--phase-width", "12",
        "--mode", "float", "--out", str(f), "--measure-floor",
    ]) == 0
    w = np.load(f)
    assert w.dtype == np.float32 and len(w) == 4096
    assert 0.9 <= w.max() <= 1.0  # unit amplitude, not quantized counts
    err = capsys.readouterr().err
    floor = json.loads(err.splitlines()[-1])["measured_sidelobe_db"]
    assert floor <= -150.0  # f32 holds ~-163 of the -180 contract


def test_spectrum_float_win_mode(tmp_path, capsys):
    n = 4 * 1024
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.25 * t).astype(np.float32)
    f = tmp_path / "x.npy"
    np.save(f, x)
    assert main([
        "spectrum", "bh4", "--phase-width", "10", "--input", str(f),
        "--win-mode", "float",
    ]) == 0
    db = np.array([float(v) for v in capsys.readouterr().out.split()])
    assert db.shape == (513,)
    assert int(np.argmax(db)) == 256  # tone at fs/4


def test_gen_comp_modes(tmp_path, capsys):
    f = tmp_path / "w.npy"
    assert main([
        "gen", "bh7", "--phase-width", "16",
        "--mode", "comp-pair", "--out", str(f), "--measure-floor",
    ]) == 0
    w = np.load(f)
    assert w.dtype == np.float32 and w.shape == (2, 65536)
    err = capsys.readouterr().err
    floor = json.loads(err.splitlines()[-1])["measured_sidelobe_db"]
    assert floor <= -180.0  # the pair holds the full BH-7 contract

    f2 = tmp_path / "wf.npy"
    assert main([
        "gen", "bh7", "--phase-width", "12", "--mode", "comp",
        "--out", str(f2),
    ]) == 0
    wf = np.load(f2)
    assert wf.dtype == np.float32 and wf.shape == (4096,)
    assert 0.9 <= wf.max() <= 1.0  # unit amplitude


def test_spectrum_comp_win_mode(tmp_path, capsys):
    n = 4 * 1024
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.25 * t).astype(np.float32)
    f = tmp_path / "x.npy"
    np.save(f, x)
    assert main([
        "spectrum", "bh4", "--phase-width", "10", "--input", str(f),
        "--win-mode", "comp",
    ]) == 0
    db = np.array([float(v) for v in capsys.readouterr().out.split()])
    assert db.shape == (513,)
    assert int(np.argmax(db)) == 256  # tone at fs/4


def test_gen_float_mode_text_output(capsys):
    assert main([
        "gen", "hann", "--phase-width", "4", "--mode", "float", "--head", "4",
    ]) == 0
    vals = [float(v) for v in capsys.readouterr().out.split()]
    assert abs(vals[0]) < 1e-6  # hann[0] = 0


def test_spectrum_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32)
    xin, xout = tmp_path / "x.npy", tmp_path / "p.npy"
    np.save(xin, x)
    assert main([
        "spectrum", "hann", "--phase-width", "9", "--data-width", "16",
        "--input", str(xin), "--out", str(xout),
    ]) == 0
    p = np.load(xout)
    assert p.shape == (257,) and np.all(np.isfinite(p)) and p.min() >= 0


def test_unknown_window():
    with pytest.raises(KeyError):
        main(["info", "nosuchwin"])


def test_spectrum_raw_i16(tmp_path, capsys):
    """Raw-capture ingest through the native stream-IO runtime."""
    n = np.arange(8192)
    tone = np.round((2**14) * np.cos(2 * np.pi * 24 / 512 * n)).astype("<i2")
    raw = tmp_path / "tone.i16"
    tone.tofile(raw)
    out = tmp_path / "pxx.npy"
    assert main([
        "spectrum", "bh4", "--phase-width", "9", "--data-width", "17",
        "--input", str(raw), "--format", "i16", "--scale", str(2.0**-14),
        "--out", str(out),
    ]) == 0
    pxx = np.load(out)
    assert pxx.shape == (257,)
    assert int(np.argmax(pxx)) == 24


def test_metrics_table(capsys):
    assert main(["metrics", "--n", "1024"]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].split()[:3] == ["name", "ENBW", "CG"]
    assert len(lines) == 1 + len(catalog.names())
    hann = next(l for l in lines if l.startswith("hann "))
    assert hann.split()[1] == "1.5000"  # closed-form ENBW of hann


def test_metrics_single_json_quantized(capsys):
    assert main(
        ["metrics", "bh4", "--n", "1024", "--data-width", "17", "--json"]
    ) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["name"] == "bh4"
    assert abs(row["enbw_bins"] - 2.0044) < 2e-3
    assert row["peak_sidelobe_db"] <= -91.0  # floor survives W=17 quantization


def test_info_reports_closed_form_merit(capsys):
    assert main(["info", "hann", "--data-width", "16"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["enbw_bins"] == 1.5 and out["coherent_gain"] == 0.5


def test_metrics_unknown_window():
    """`metrics <unknown>` gets the loud catalog error, not a bare KeyError
    traceback from the table index."""
    with pytest.raises(KeyError, match="available"):
        main(["metrics", "nosuchwin"])


def test_stft_complex_npy_input(tmp_path):
    """A complex .npy input takes .real (same handling as raw ci16)."""
    nfft, hop = 256, 128
    n = np.arange(nfft + 4 * hop)
    x = np.exp(2j * np.pi * 16 / nfft * n).astype(np.complex64)
    f_in, f_out = tmp_path / "x.npy", tmp_path / "s.npy"
    np.save(f_in, x)
    assert main([
        "stft", "bh4", "--phase-width", "8", "--data-width", "17",
        "--input", str(f_in), "--out", str(f_out),
    ]) == 0
    s = np.load(f_out)
    assert s.shape == (5, nfft // 2 + 1)
    assert (np.abs(s).argmax(axis=1) == 16).all()


def test_stft_input_shorter_than_frame(tmp_path):
    f_in = tmp_path / "x.npy"
    np.save(f_in, np.zeros(100, np.float32))
    with pytest.raises(SystemExit, match="nfft"):
        main(["stft", "bh4", "--phase-width", "8", "--data-width", "17",
              "--input", str(f_in)])


def test_design_reproduces_minimum_4term(capsys):
    """CLI design: K=4 lands on the catalog's blackman_nuttall set (the true
    -98 dB minimax optimum) and sizes the width by the 6 dB/bit rule."""
    assert main(["design", "4", "--measure-floor"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["sidelobe_db"] < -97.0
    assert out["data_width"] == 18 and out["shift"] == 1
    bn = catalog.get("blackman_nuttall").coeffs
    assert np.allclose(out["coeffs"], bn, atol=1e-4)
    assert out["measured_sidelobe_db"] < -97.0
    assert sum(out["quantized"]) <= 2**17 - 1  # peak-overflow trim holds


def test_design_null_and_outfile(tmp_path, capsys):
    f = tmp_path / "coeffs.txt"
    assert main([
        "design", "4", "--null", "9.5", "--data-width", "17",
        "--out", str(f),
    ]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[0])
    from blackman_harris_win.windows.design import cosine_sum_spectrum

    assert abs(cosine_sum_spectrum(out["coeffs"], 9.5)[0]) < 1e-12
    q = np.loadtxt(f, dtype=np.int64)
    assert tuple(q) == tuple(out["quantized"]) and len(q) == 4


def test_stft_frames_npy(tmp_path, capsys):
    nfft, hop = 256, 128
    n = np.arange(nfft + 10 * hop + 37)  # deliberately untiled length
    x = np.sin(2 * np.pi * 16 / nfft * n).astype(np.float32)
    f_in, f_out = tmp_path / "x.npy", tmp_path / "s.npy"
    np.save(f_in, x)
    assert main([
        "stft", "bh4", "--phase-width", "8", "--data-width", "17",
        "--input", str(f_in), "--out", str(f_out),
    ]) == 0
    s = np.load(f_out)
    assert s.shape == (11, nfft // 2 + 1) and np.iscomplexobj(s)
    # the tone shows up in bin 16 of every frame
    assert (np.abs(s).argmax(axis=1) == 16).all()


def test_gen_taylor_source_bit_exact(tmp_path):
    """CLI gen --sin-type taylor rides the gather-free block kernel
    (make_window routing) and stays bit-exact vs the scalar golden."""
    f = tmp_path / "w.npy"
    assert main([
        "gen", "blackman", "--phase-width", "11", "--data-width", "16",
        "--sin-type", "taylor", "--lut-size", "9", "--overflow", "wrap",
        "--out", str(f),
    ]) == 0
    w = np.load(f)
    assert len(w) == 2048
    q = catalog.get("blackman").quantized(16)
    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import window_samples

    spec = WindowSpec(11, 16, sin_type="taylor", lut_size=9,
                      overflow="wrap")
    want = np.asarray(window_samples(np.arange(2048), q, spec))
    np.testing.assert_array_equal(w, want)


def test_ddc_subcommand(tmp_path, capsys):
    import numpy as np

    fc, df, dec = 1 / 8, 1 / 256, 4
    x = np.cos(2 * np.pi * (fc + df) * np.arange(8192)).astype(np.float32)
    inp = tmp_path / "x.npy"
    np.save(inp, x)
    out = tmp_path / "bb.npy"
    rc = main(["ddc", "--input", str(inp), "--freq", str(fc),
               "--decim", str(dec), "--out", str(out)])
    assert rc == 0
    bb = np.load(out)
    assert bb.shape == (2, 8192 // dec)
    z = (bb[0].astype(np.float64) + 1j * bb[1])[16:-16]
    f_meas = np.mean(np.diff(np.unwrap(np.angle(z)))) / (2 * np.pi * dec)
    assert abs(f_meas - df) < 1e-4


def test_spectrum_fft_mode_mxu(tmp_path, capsys):
    import numpy as np

    x = np.sin(2 * np.pi * 0.1 * np.arange(4096)).astype(np.float32)
    inp = tmp_path / "x.npy"
    np.save(inp, x)
    outs = {}
    for mode in ("rfft", "mxu"):
        out = tmp_path / f"p_{mode}.npy"
        rc = main(["spectrum", "bh4", "--input", str(inp),
                   "--phase-width", "9", "--fft-mode", mode,
                   "--out", str(out)])
        assert rc == 0
        outs[mode] = np.load(out)
    a, b = outs["rfft"].astype(np.float64), outs["mxu"].astype(np.float64)
    assert np.max(np.abs(a - b) / (np.abs(a).max() + 1e-300)) < 2e-6


def test_stft_complex_output_matches_f64(tmp_path):
    """The stft command copies the complex frames straight to the host:
    every bin equals the float64 STFT of the same quantized window."""
    from blackman_harris_win.model import native

    nfft, hop = 256, 128
    x = np.random.default_rng(7).standard_normal(nfft + 6 * hop)
    x = x.astype(np.float32)
    f_in, f_out = tmp_path / "x.npy", tmp_path / "s.npy"
    np.save(f_in, x)
    assert main([
        "stft", "bh4", "--phase-width", "8", "--data-width", "17",
        "--input", str(f_in), "--out", str(f_out),
    ]) == 0
    s = np.load(f_out)
    assert s.dtype == np.complex64 and s.shape == (7, nfft // 2 + 1)
    d = catalog.get("bh4")
    win = native.win_hls(np.arange(nfft), d.quantized(17), 8, 17) / (
        2.0 ** (17 - d.shift) - 1.0)
    frames = np.stack([x[m * hop: m * hop + nfft] for m in range(7)])
    ref = np.fft.rfft(frames.astype(np.float64) * win, axis=-1)
    # f32 FFT vs float64: 32 * 2^-24 * sqrt(nfft) relative to the peak
    assert np.max(np.abs(s - ref)) < 32 * 2.0**-24 * 16 * np.max(np.abs(ref))
