"""Generation-mode advisor (windows/modes.py) + CLI `suggest`."""

import json

import pytest

from blackman_harris_win.__main__ import main
from blackman_harris_win.windows.modes import recommend_mode


class TestRecommend:
    def test_float_consumer_shallow_floor_is_plain_f32(self):
        r = recommend_mode("bh5")  # -124 dB: plain f32 holds it
        assert r.mode == "float"

    def test_float_consumer_deep_floor_is_comp(self):
        r = recommend_mode("bh7")  # -180 dB: beyond plain f32's ~-163
        assert r.mode == "comp"

    def test_target_overrides_published(self):
        assert recommend_mode("bh7", target_db=-150.0).mode == "float"
        assert recommend_mode("bh5", target_db=-170.0).mode == "comp"

    def test_int_bit_exact_2_3_term_is_taylor(self):
        # the non-obvious rule: TAYLOR is a reference contract AND does a
        # fraction of the CORDIC datapath's per-sample work
        assert recommend_mode("hamming", consumer="int",
                              exactness="bit-exact").mode == "taylor"
        assert recommend_mode("blackman", consumer="int",
                              exactness="bit-exact").mode == "taylor"

    def test_int_bit_exact_many_terms_is_exact(self):
        assert recommend_mode("bh7", consumer="int",
                              exactness="bit-exact").mode == "exact"

    def test_int_floor_is_outer(self):
        assert recommend_mode("bh7", consumer="int").mode == "outer"

    def test_float_bit_exact_is_comp(self):
        assert recommend_mode("bh4", consumer="float",
                              exactness="bit-exact").mode == "comp"

    def test_coeff_tuple_defaults_deep(self):
        assert recommend_mode((0.27, 0.43, 0.22, 0.066, 0.011, 8e-4,
                               1.4e-5)).mode == "comp"

    def test_bad_args(self):
        with pytest.raises(ValueError, match="consumer"):
            recommend_mode("bh4", consumer="complex")
        with pytest.raises(ValueError, match="exactness"):
            recommend_mode("bh4", exactness="sorta")


class TestCli:
    def test_suggest_json(self, capsys):
        assert main(["suggest", "bh7"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["mode"] == "comp"
        assert "compwin" in out["rationale"]

    def test_suggest_int_bit_exact(self, capsys):
        assert main(["suggest", "hamming", "--consumer", "int",
                     "--exactness", "bit-exact"]) == 0
        assert json.loads(capsys.readouterr().out)["mode"] == "taylor"

    def test_suggest_unknown_window(self, capsys):
        assert main(["suggest", "nope"]) == 2
