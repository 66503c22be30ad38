"""chip_smoke.py at a tiny size on the CPU: every phase against its
reference, the sharded phases on four virtual devices, and the refusal to
run without a GPU.  (On the card the same functions run at full size.)"""

import json

import jax
import pytest

import chip_smoke


@pytest.fixture
def tiny_run(tmp_path):
    lines = []
    run = chip_smoke.Run(chip_smoke.TINY, seed=3, workdir=tmp_path,
                         emit=lines.append)
    run.lines = lines
    return run


@pytest.mark.parametrize("name", sorted(chip_smoke.PHASES))
def test_phase_matches_reference(name, tiny_run):
    tiny_run.phase = name
    with jax.enable_x64(False):
        chip_smoke.PHASES[name](tiny_run)
    timings = [json.loads(ln.split(" ", 1)[1]) for ln in tiny_run.lines
               if ln.startswith("timing ")]
    assert timings and all(t["phase"] == name for t in timings)
    assert all(t["msamp_s"] > 0 for t in timings)


def test_sharded_phases_on_four_devices(tiny_run):
    with jax.enable_x64(False):
        chip_smoke.sharded_phases(tiny_run, 4)
    phases = {json.loads(ln.split(" ", 1)[1])["phase"]
              for ln in tiny_run.lines if ln.startswith("finding ")}
    assert phases == {"sharded-gen", "sharded-welch", "sharded-stft",
                      "sharded-sdr", "sharded-ddc"}


def test_check_raises_on_mismatch():
    with pytest.raises(chip_smoke.CheckFailed, match="differs"):
        chip_smoke.check(False, "it differs")


def test_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(SystemExit) as ex:
        chip_smoke.main([])
    assert ex.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_require_gpu_raises_on_cpu():
    from blackman_harris_win.utils.profiling import require_gpu

    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        require_gpu()
