"""``repro_torch.examples.elastic_restart`` end to end on the CPU: mistral-
nemo SMOKE through 2x2 -> 1x2 -> 2x2 meshes of gloo ranks (one
``torchrun --standalone`` per phase); each resumed phase's restored leaves
equal the saved files bit for bit, and the run ends with its OK line.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_attention import _one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]))


def test_elastic_restart_twin():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.elastic_restart",
         "--device", "cpu", "--meshes", "2x2,1x2,2x2", "--steps", "1,1,1"],
        env=_env(), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "resumed at step 1 on mesh 1x2" in out.stdout
    assert "resumed at step 2 on mesh 2x2" in out.stdout
    assert out.stdout.count("restored leaves bitwise equal") == 2
    assert "OK: one logical run survived two mesh changes" in out.stdout
