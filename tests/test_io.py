"""Native stream-IO runtime (native/stream_io.cpp via utils/io.py):
format conversions vs numpy reference, block clamping, resume checksum,
and the .dat writer round-trip."""

import numpy as np
import pytest

from blackman_harris_win.utils import io as sio


@pytest.fixture(scope="module", autouse=True)
def _built():
    sio.build()


class TestSampleSource:
    def test_i16_blocks(self, tmp_path):
        rng = np.random.default_rng(0)
        data = rng.integers(-(1 << 15), 1 << 15, size=10000).astype("<i2")
        p = tmp_path / "x.i16"
        data.tofile(p)
        with sio.SampleSource(p, "i16", scale=2.0**-15) as src:
            assert len(src) == 10000
            blk = src.read_block(1234, 256)
            np.testing.assert_array_equal(
                blk, data[1234:1490].astype(np.float32) * np.float32(2.0**-15)
            )
            # end-of-file clamp, no zero fill
            tail = src.read_block(9990, 256)
            assert tail.shape == (10,)
            # out of range
            assert src.read_block(20000, 16).shape == (0,)

    def test_i8_and_f32(self, tmp_path):
        rng = np.random.default_rng(1)
        d8 = rng.integers(-128, 128, size=512).astype(np.int8)
        p8 = tmp_path / "x.i8"
        d8.tofile(p8)
        with sio.SampleSource(p8, "i8") as src:
            np.testing.assert_array_equal(
                src.read_block(0, 512), d8.astype(np.float32)
            )
        df = rng.normal(size=512).astype("<f4")
        pf = tmp_path / "x.f32"
        df.tofile(pf)
        with sio.SampleSource(pf, "f32", scale=0.5) as src:
            np.testing.assert_allclose(
                src.read_block(100, 128), df[100:228] * 0.5, rtol=1e-7
            )

    def test_ci16_iq(self, tmp_path):
        rng = np.random.default_rng(2)
        iq = rng.integers(-(1 << 15), 1 << 15, size=2048).astype("<i2")
        p = tmp_path / "x.ci16"
        iq.tofile(p)
        with sio.SampleSource(p, "ci16", scale=2.0**-15) as src:
            assert len(src) == 1024  # IQ pairs
            blk = src.read_block(10, 100)
            want = (iq[20:220:2] + 1j * iq[21:220:2]).astype(
                np.complex64
            ) * np.complex64(2.0**-15)
            np.testing.assert_allclose(blk, want, rtol=1e-6)

    def test_checksum_stability(self, tmp_path):
        data = np.arange(1000, dtype="<i2")
        p = tmp_path / "x.i16"
        data.tofile(p)
        with sio.SampleSource(p, "i16") as a, sio.SampleSource(p, "i16") as b:
            assert a.checksum() == b.checksum() != 0
            assert a.checksum(0, 100) != a.checksum(100, 100)

    def test_missing_file(self, tmp_path):
        with pytest.raises(OSError):
            sio.SampleSource(tmp_path / "nope.i16")

    def test_bad_format(self, tmp_path):
        with pytest.raises(ValueError):
            sio.SampleSource(tmp_path / "x", fmt="u64")


class TestWriter:
    def test_i32_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        w = rng.integers(-(1 << 31), 1 << 31, size=4096, dtype=np.int64)
        w32 = w.astype(np.int32)
        p = tmp_path / "win.dat"
        assert sio.write_i32(p, w32) == 4096
        back = np.fromfile(p, dtype="<i4")
        np.testing.assert_array_equal(back, w32)


class TestPipelineIntegration:
    def test_welch_from_file(self, tmp_path):
        """End-to-end: raw i16 capture -> native ingest -> Welch analyzer."""
        import jax.numpy as jnp

        from blackman_harris_win.core.config import WindowSpec
        from blackman_harris_win.pipeline.spectral import (
            windowed_power_spectrum,
        )

        n = np.arange(8192)
        tone = np.round(
            (2**14) * np.cos(2 * np.pi * 16 / 512 * n)
        ).astype("<i2")
        p = tmp_path / "tone.i16"
        tone.tofile(p)

        with sio.SampleSource(p, "i16", scale=2.0**-14) as src:
            x = src.read_block(0, len(src))
        spec = WindowSpec(9, 17)  # nfft = 512
        pxx = np.asarray(windowed_power_spectrum(jnp.asarray(x), "bh4", spec))
        assert int(np.argmax(pxx)) == 16
