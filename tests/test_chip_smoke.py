"""`chip_smoke.py` on the CPU: every phase at tiny sizes with the traversal
kernel in Pallas interpret mode, and the exit contract without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_device_cpu():
    dev = chip_smoke.phase_device(cpu=True)
    assert dev.platform == "cpu"


def test_phase_traversal_cpu():
    chip_smoke.phase_traversal(chip_smoke.TINY, "interpret")


def test_phase_frames_cpu():
    fps = chip_smoke.phase_frames(chip_smoke.TINY, "interpret")
    assert set(fps) == {"lambert_noise64", "full_default_scene"}
    for v in fps.values():
        assert set(v) == {"interpret", "xla"}


def test_phase_training_cpu():
    assert chip_smoke.phase_training(chip_smoke.TINY) > 0


def test_phase_devices_cpu():
    """The four-device mesh phase on four of the virtual CPU devices."""
    chip_smoke.phase_devices(chip_smoke.TINY, 4)


def test_compare_hits_bounds():
    ref = {"t": np.array([1.0, 2.0, 1e30] * 4000, np.float32),
           "mat": np.ones(12000, np.int32)}
    got = {k: v.copy() for k, v in ref.items()}
    got["mat"][0] = 2
    chip_smoke.compare_hits("one flip in 12000", ref, got)   # 8.3e-5 of rays
    got["mat"][3] = 2
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.compare_hits("two flips", ref, got)       # 1.7e-4
    got["mat"][:] = 1
    got["t"][1] *= 1.0 + 1e-4
    with pytest.raises(AssertionError, match="t rel err"):
        chip_smoke.compare_hits("t drift", ref, got)


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_exits_nonzero_without_gpu():
    p = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT)
    assert p.returncode != 0
    assert _last_json(p.stdout) is None
    assert "no GPU" in p.stderr + p.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    assert _last_json(p.stdout) is None
