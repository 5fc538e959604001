"""``python -m repro_torch.launch.train --host-mesh --model-parallel 2``
end to end on the CPU (gloo ranks started by ``torchrun --standalone``,
which picks a free port): ``kan_llm`` SMOKE on the ``fused`` backend on a
2x2 mesh of 4 ranks with a checkpoint at step 2, then resumed on a 1x2
mesh of 2 ranks to step 4 through ``restore(shardings=)``: every step's
loss within ``1e-5`` relative of one process running the same command
without the mesh (same seed, batches and ``--steps``; the schedule
depends on it), and only rank 0 prints.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_attention import _one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")
TRAIN = ["--arch", "kan_llm", "--kan-backend", "fused", "--smoke",
         "--device", "cpu", "--batch", "4", "--seq", "16", "--log-every",
         "1"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]))


def _torchrun(n, args, timeout=600):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", *args], env=_env(),
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_launcher_host_mesh_resumes_on_another_mesh(tmp_path):
    from repro_torch.launch import train
    ck, a, b = (str(tmp_path / n) for n in ("ck", "a.json", "b.json"))
    first = _torchrun(4, ["repro_torch.launch.train", *TRAIN, "--host-mesh",
                          "--model-parallel", "2", "--steps", "2",
                          "--ckpt-dir", ck, "--save-every", "2",
                          "--losses-out", a])
    assert first.count("step 0: loss=") == 1      # rank 0 alone prints
    second = _torchrun(2, ["repro_torch.launch.train", *TRAIN, "--host-mesh",
                           "--model-parallel", "2", "--steps", "4",
                           "--ckpt-dir", ck, "--losses-out", b])
    assert "resumed from step 2" in second
    with open(a) as f:
        ra = json.load(f)
    with open(b) as f:
        rb = json.load(f)
    assert ra["start"] == 0 and rb["start"] == 2
    ref = train.main(TRAIN + ["--steps", "4"])["losses"]
    got = ra["losses"] + rb["losses"]
    assert len(got) == 4
    for x, y in zip(got, ref):
        assert abs(x - y) <= 1e-5 * abs(y), (got, ref)
