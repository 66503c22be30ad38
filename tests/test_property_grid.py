"""Property tests across the (PHASE_WIDTH, DATA_WIDTH) generic grid.

SURVEY.md §4: the reference parameterizes everything by two generics; this
library must hold bit-exactness across the grid, not just at the configs
the reference shipped.  The native C++ oracle makes wide grids affordable.
"""

import numpy as np
import pytest

from blackman_harris_win.core.config import CordicSpec, WindowSpec
from blackman_harris_win.kernels import cordic as kc
from blackman_harris_win.kernels import window as kw
from blackman_harris_win.model import native
from blackman_harris_win.windows import catalog


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.build()


def _phases(pw, count=600, seed=7):
    n = 1 << pw
    rng = np.random.default_rng(seed + pw)
    base = rng.integers(0, n, size=count)
    seams = np.array([0, 1, n // 4 - 1, n // 4, n // 4 + 1, n // 2 - 1,
                      n // 2, n // 2 + 1, 3 * n // 4, n - 1]) % n
    return np.unique(np.concatenate([base, seams]))


HLS_GRID = [(pw, w) for pw in (6, 10, 13, 20, 26)
            for w in (8, 12, 16, 17, 21, 24, 28, 30, 31, 32)]


class TestHlsGrid:
    @pytest.mark.parametrize("pw,w", HLS_GRID)
    def test_cordic_hls(self, pw, w):
        n = _phases(pw)
        c, s = kc.cordic_sincos(n, CordicSpec(pw, w, "hls"))
        nc, ns = native.cordic_hls(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc, err_msg=f"{pw},{w}")
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns, err_msg=f"{pw},{w}")


class TestOtherFlavorGrids:
    @pytest.mark.parametrize("pw", [8, 12, 16])
    @pytest.mark.parametrize("w", [10, 16, 24, 30])
    @pytest.mark.parametrize("p", [1, 4, 7])
    def test_cordic_dds(self, pw, w, p):
        n = _phases(pw, count=200)
        c, s = kc.cordic_sincos(n, CordicSpec(pw, w, "dds", p))
        nc, ns = native.cordic_dds(n, pw, w, p)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("pw,w", [(8, 10), (12, 16), (16, 24), (18, 32),
                                      (24, 40), (26, 46)])
    def test_cordic_dds48(self, pw, w):
        n = _phases(pw, count=300)
        c, s = kc.cordic_sincos(n, CordicSpec(pw, w, "dds48"))
        nc, ns = native.cordic_dds48(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)

    @pytest.mark.parametrize("w", [8, 12, 16, 20, 24, 28, 32])
    def test_cordic_scaled(self, w):
        pw = 12
        n = _phases(pw, count=300)
        c, s = kc.cordic_sincos(n, CordicSpec(pw, w, "scaled"))
        nc, ns = native.cordic_scaled(n, pw, w)
        np.testing.assert_array_equal(np.asarray(c, np.int64), nc)
        np.testing.assert_array_equal(np.asarray(s, np.int64), ns)


class TestWindowGrid:
    @pytest.mark.parametrize("name", ["hann", "bh3_hls", "bh4", "bh5", "bh7"])
    @pytest.mark.parametrize("pw,w", [(8, 12), (10, 17), (12, 24), (14, 32)])
    def test_window_hls(self, name, pw, w):
        n = _phases(pw, count=400)
        spec = WindowSpec(pw, w, overflow="wrap")
        q = catalog.get(name).quantized(w)
        jw = np.asarray(kw.window_samples(n, q, spec), np.int64)
        nw = native.win_hls(n, q, pw, w)
        np.testing.assert_array_equal(jw, nw, err_msg=f"{name},{pw},{w}")


class TestMultihostHelpers:
    def test_pod_mesh_virtual(self):
        import jax
        from blackman_harris_win.dist import multihost

        multihost.initialize()  # degenerate single-process path
        mesh = multihost.pod_mesh(channels=2)
        assert mesh.shape == {"channels": 2, "blocks": len(jax.devices()) // 2}
        with pytest.raises(ValueError):
            multihost.pod_mesh(channels=3)  # 8 % 3 != 0

    def test_process_block_range(self):
        from blackman_harris_win.dist import multihost

        mesh = multihost.pod_mesh(channels=1)
        start, end = multihost.process_block_range(1 << 12, mesh)
        # single process owns everything
        assert (start, end) == (0, 1 << 12)

    def test_sharded_window_on_pod_mesh(self):
        import numpy as np

        from blackman_harris_win.dist import multihost
        from blackman_harris_win.dist.generate import sharded_window
        from blackman_harris_win.kernels.window import make_window

        mesh = multihost.pod_mesh(channels=1)
        spec = WindowSpec(12, 17)
        q = catalog.get("bh4").quantized(17)
        ws = np.asarray(sharded_window(q, spec, mesh))
        w1 = np.asarray(make_window("bh4", spec))
        np.testing.assert_array_equal(ws, w1)
