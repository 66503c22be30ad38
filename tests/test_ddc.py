"""DDC (digital downconverter): NCO phase math, integer mixer, tone shift,
image rejection, sharded == single-device.

The NCO is the reference's dds48 engine in its titular DDS role
(src/cordic_dds48.vhd:9-14); its -sin axis quirk is consumed as the
downconversion mixer phase directly.
"""

import numpy as np
import pytest

from blackman_harris_win.model import golden
from blackman_harris_win.pipeline.ddc import (
    MIX_IN_BITS,
    ddc,
    freq_word,
    make_sharded_ddc,
    mix_iq_int,
    nco_iq,
)


class TestNco:
    def test_freq_word(self):
        assert freq_word(1 / 8, 20) == 1 << 17
        assert freq_word(0.0, 20) == 0
        # wraps mod 2^pw (negative freq == complement word)
        assert freq_word(-1 / 8, 20) == (1 << 20) - (1 << 17)

    def test_nco_is_dds48_with_quirk(self):
        """nco_iq == (DT_COS, DT_SIN) of dds48 — DT_SIN carries -sin."""
        pw, w = 12, 16
        fw = freq_word(3 / 16, pw)
        n = np.arange(64)
        c, ns = nco_iq(n, fw, pw, w)
        for i in range(64):
            ph = (int(n[i]) * fw) % (1 << pw)
            gc, gns = golden.cordic_dds48(ph, pw, w)
            assert int(c[i]) == gc, i
            assert int(ns[i]) == gns, i
        # the quirk really is -sin: compare against float -sin
        th = 2 * np.pi * ((n * fw) % (1 << pw)) / (1 << pw)
        amp = 2.0 ** (w - 2)
        assert np.max(np.abs(np.asarray(ns) - (-amp) * np.sin(th))) < 8

    def test_phase_wrap_is_exact_for_large_n(self):
        """(n * fw) & mask must be exact under int32 wrap for any n."""
        pw = 20
        fw = freq_word(0.2371, pw)
        n = np.array([0, 1, 2**30 - 5, 2**31 - 1], np.int64)
        c, ns = nco_iq(n.astype(np.int32), fw, pw, 16)
        for i, ni in enumerate(n):
            ph = (int(ni) * fw) % (1 << pw)
            gc, gns = golden.cordic_dds48(ph, pw, 16)
            assert int(c[i]) == gc and int(ns[i]) == gns, ni


class TestMixer:
    def test_product_bound_guard(self):
        with pytest.raises(ValueError, match="int32 lanes"):
            mix_iq_int(np.zeros(4, np.int32), np.arange(4), 0, 12, 19)

    def test_integer_products_exact(self):
        pw, w = 12, 16
        fw = freq_word(1 / 6, pw)
        rng = np.random.default_rng(3)
        xq = rng.integers(-(1 << MIX_IN_BITS) + 1, 1 << MIX_IN_BITS,
                          size=128).astype(np.int32)
        n = np.arange(128, dtype=np.int32)
        mi, mq = mix_iq_int(xq, n, fw, pw, w)
        for i in range(128):
            ph = (int(n[i]) * fw) % (1 << pw)
            gc, gns = golden.cordic_dds48(ph, pw, w)
            assert int(mi[i]) == int(xq[i]) * gc
            assert int(mq[i]) == int(xq[i]) * gns


class TestDdc:
    def _tone(self, f, t):
        return np.cos(2 * np.pi * f * np.arange(t)).astype(np.float32)

    def test_tone_shift(self):
        """A tone at fc + df comes out of the DDC as a baseband complex
        tone at df (amplitude ~0.5 — real mixing halves the power)."""
        fc, df, decim, t = 1 / 8, 1 / 256, 4, 8192
        bb = np.asarray(ddc(self._tone(fc + df, t), fc, decim))
        assert bb.shape == (2, t // decim)
        z = bb[0].astype(np.float64) + 1j * bb[1]
        z = z[16:-16]  # FIR circular-wrap edges
        ph = np.unwrap(np.angle(z))
        f_meas = np.mean(np.diff(ph)) / (2 * np.pi * decim)
        assert abs(f_meas - df) < 1e-4
        assert abs(np.mean(np.abs(z)) - 0.5) < 0.02

    def test_image_rejection(self):
        """The -(2 fc + df) mixing image must sit below -60 dBc after the
        lowpass (it aliases to -df_out post-decimation; measure the -df
        bin against the +df bin)."""
        fc, decim, t = 1 / 8, 4, 8192
        df = 8 / t  # bin-exact at the output length
        bb = np.asarray(ddc(self._tone(fc + df, t), fc, decim))
        z = bb[0].astype(np.float64) + 1j * bb[1]
        sp = np.abs(np.fft.fft(z * np.hanning(len(z)))) ** 2
        k = round(df * decim * len(z))  # output-rate bin of df
        want = sp[k]
        image = sp[len(z) - k]
        assert 10 * np.log10(image / want) < -60

    def test_dc_of_zero_freq_nco(self):
        """freq = 0: the DDC is just the decimating lowpass of x (I) with
        Q ~ 0."""
        decim, t = 4, 4096
        x = self._tone(1 / 512, t)
        bb = np.asarray(ddc(x, 0.0, decim))
        assert np.max(np.abs(bb[1])) < 1e-3  # -sin(0) == 0 channel
        assert abs(np.max(bb[0]) - 1.0) < 0.02

    def test_sharded_matches_single_device(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from blackman_harris_win.dist.mesh import make_mesh

        n_dev = len(jax.devices())
        mesh = make_mesh(blocks=n_dev)
        fc, decim = 1 / 8, 4
        t = n_dev * 1024
        x = self._tone(fc + 0.004, t)
        got = np.asarray(
            jax.jit(make_sharded_ddc(mesh, 20, 16, fc, decim))(
                jax.device_put(jnp.asarray(x),
                               NamedSharding(mesh, P("blocks")))
            )
        )
        # same flavor on both sides (the sharded builder defaults to
        # "scaled" — see its docstring for the XLA:CPU dds48 wedge)
        want = np.asarray(ddc(x, fc, decim, flavor="scaled"))
        assert got.shape == want.shape == (2, t // decim)
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_flavors_agree(self):
        """dds48 and scaled NCOs differ only in CORDIC truncation noise —
        the basebands must agree to ~the NCO LSB scale."""
        fc, decim, t = 1 / 8, 4, 4096
        x = self._tone(fc + 0.004, t)
        a = np.asarray(ddc(x, fc, decim, flavor="dds48"))
        b = np.asarray(ddc(x, fc, decim, flavor="scaled"))
        assert np.max(np.abs(a - b)) < 1e-3

    def test_nco_scaled_matches_golden(self):
        from blackman_harris_win.pipeline.ddc import nco_iq

        pw, w = 12, 16
        fw = freq_word(3 / 16, pw)
        n = np.arange(64)
        c, ns = nco_iq(n, fw, pw, w, flavor="scaled")
        for i in range(64):
            ph = (int(n[i]) * fw) % (1 << pw)
            gc, gns = golden.cordic_scaled(ph, pw, w)
            assert int(c[i]) == gc and int(ns[i]) == gns, i
