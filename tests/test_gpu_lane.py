"""GPU lane: the int32-lane datapaths compiled for the card, against the
golden models, in the production regime (x64 off).

The default suite runs on the CPU backend (tests/conftest.py).  These tests
carry the ``gpu`` marker and skip unless the first JAX device is a GPU; the
check runs in the ``gpu`` fixture.  Run them on a machine with an NVIDIA
GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_lane.py -q
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda); first "
                    f"device is {dev.platform}")
    with jax.enable_x64(False):
        yield dev


def test_rtl_w32_window_on_chip(gpu):
    """The VHDL rounding contract at W=32 executes on the card's int32 lanes
    (routed via kernels/window.py without x64) bit-exactly."""
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.window import window_samples
    from blackman_harris_win.model import golden
    from blackman_harris_win.windows import catalog

    pw, w = 12, 32
    spec = WindowSpec(pw, w, rounding="rtl", overflow="wrap")
    q = catalog.get("bh7").quantized(w)
    n = np.arange(0, 1 << pw, 29, dtype=np.int32)
    # jitted: eager execution would compile each unrolled int op on its own
    fn = jax.jit(lambda nn: window_samples(nn, q, spec))
    got = np.asarray(fn(jnp.asarray(n)))
    for j in range(0, len(n), 5):
        want = golden.win_cosine_sum_rtl(
            int(n[j]), tuple(int(c) for c in q), pw, w
        )
        assert int(got[j]) == want, int(n[j])


@pytest.mark.parametrize("flavor,w", [("dds48", 24), ("scaled", 20), ("hls", 32)])
def test_wide_cordic_flavors_on_chip(gpu, flavor, w):
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.core.config import CordicSpec
    from blackman_harris_win.kernels import cordic as kc
    from blackman_harris_win.model import golden

    pw = 10
    ph = np.arange(0, 1 << pw, 3, dtype=np.int32)
    fn = jax.jit(lambda p: kc.cordic_sincos(p, CordicSpec(pw, w, flavor)))
    c, s = fn(jnp.asarray(ph))
    gfn = {
        "dds48": golden.cordic_dds48,
        "scaled": golden.cordic_scaled,
        "hls": golden.cordic_hls,
    }[flavor]
    for j in range(0, len(ph), 7):
        assert (int(c[j]), int(s[j])) == gfn(int(ph[j]), pw, w), int(ph[j])


def test_comp_pair_accuracy_on_chip(gpu):
    """Compensated-f32 on the card: the error-free-grid argument assumes
    IEEE f32 multiply/add — this pins it on hardware.  A compiled
    pair block spanning the quadrant seam must match the f64 golden to
    pair accuracy (< 5e-9; plain f32 would read ~1e-7)."""
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.kernels.compwin import comp_window_block
    from blackman_harris_win.windows.catalog import float_window_value

    pw, m = 20, 11
    n0 = (1 << (pw - 2)) - (1 << m)  # block spans the N/4 seam
    fn = jax.jit(lambda: comp_window_block(jnp.int32(n0), 2, "bh7", pw, m=m))
    hi, lo = fn()
    pair = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    idx = n0 + np.arange(2 << m)
    gold = float_window_value("bh7", idx, 1 << pw)
    assert np.max(np.abs(pair - gold)) < 5e-9
    # host normalization of the raw device pair is exact and non-overlapping
    from blackman_harris_win.kernels.compwin import normalize_pair

    nh, nl_ = normalize_pair(np.asarray(hi), np.asarray(lo))
    np.testing.assert_array_equal(
        nh, (nh.astype(np.float64) + nl_.astype(np.float64)).astype(np.float32)
    )


def test_w32_saturate_tracking_on_chip(gpu):
    """The w=32 overflow-count saturate path on the card's int32
    lanes: an overflowing 31-bit-packed set clamps exactly where the exact
    accumulator leaves the range."""
    import jax
    import jax.numpy as jnp

    from blackman_harris_win.core.config import WindowSpec
    from blackman_harris_win.kernels.pallas.window_kernel import (
        window_values,
    )
    from blackman_harris_win.model import golden

    pw = 12
    q = (576778032, 925936728, 472185493, 145944170, 24743018,
         1860917, 35296)
    n = np.array([0, 1024, 2047, 2048, 2049, 4095], np.int64)
    sat = WindowSpec(pw, 32, rounding="hls", overflow="saturate")
    fn = jax.jit(lambda nn: window_values(nn, q, sat))
    got = np.asarray(fn(jnp.asarray(n, jnp.int32))).astype(np.int64)

    def exact(ni):
        acc = q[0]
        for k in range(1, len(q)):
            c, _ = golden.cordic_hls((k * ni) % (1 << pw), pw, 32)
            m = (q[k] * c) >> 30
            acc = acc - m if k % 2 == 1 else acc + m
        return max(-(1 << 31), min((1 << 31) - 1, acc))

    for i, ni in enumerate(n):
        assert int(got[i]) == exact(int(ni)), ni
    assert int(got[3]) == (1 << 31) - 1  # the clamped peak
