"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
``repro``, and its entry points run on the card unless told otherwise."""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cf_kan_1  # noqa: E402
from repro_torch.core import kan, kan_sam  # noqa: E402
from repro_torch.examples import kan_neurosim_search  # noqa: E402
from repro_torch.examples import quickstart, train_cf_kan  # noqa: E402
from repro_torch.examples import serve_kan_llm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.configs import mamba2_1p3b  # noqa: E402
from repro_torch.models import cf_kan  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import decode, engine  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

SRC = Path(__file__).resolve().parents[1] / "src"
SERVING_MODULES = ("serve.engine", "serve.paging", "serve.scheduler",
                   "obs", "obs.export", "obs.metrics", "obs.profile",
                   "obs.recorder", "obs.sketch", "obs.slo", "obs.trace",
                   "launch.serve", "examples.serve_kan_llm",
                   # the fleet and MoE slice
                   "serve.router", "hw.health", "dist", "dist.fault",
                   "models.moe", "configs.mixtral_8x7b",
                   "configs.kimi_k2_1t_a32b")
TRAINING_MODULES = ("optim", "optim.optimizers", "train.train_step",
                    "checkpoint.checkpoint", "launch.train",
                    "configs.whisper_base", "configs.internvl2_76b")
MESH_MODULES = ("dist.sharding", "dist.compress", "launch.mesh",
                "examples.elastic_restart")


def test_imports_with_jax_and_repro_blocked():
    """Every module of the package imports in a process where ``jax`` and
    ``repro`` cannot be imported."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None      # any import of them now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15
    # the serving, training and mesh slices' modules among them
    assert {f"repro_torch.{m}" for m in SERVING_MODULES + TRAINING_MODULES
            + MESH_MODULES} <= names


def test_sources_name_no_jax_or_repro():
    """No module of the package, and not ``chip_smoke.py``, names ``jax``
    or ``repro`` in an import."""
    paths = [*(SRC / "repro_torch").rglob("*.py"),
             SRC.parent / "chip_smoke.py"]
    assert paths[-1].exists()
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "repro"), (
                    path, line)


def test_no_message_names_the_router_slice():
    """The router slice is ported: no module of the package, and not
    ``chip_smoke.py``, still says that it is to come."""
    paths = [*(SRC / "repro_torch").rglob("*.py"),
             SRC.parent / "chip_smoke.py"]
    for path in paths:
        text = path.read_text()
        for phrase in ("ROUTER_SLICE", "Slice E part 2", "the router)",
                       "is not ported yet: ROADMAP Slice D4"):
            assert phrase not in text, (path, phrase)
    assert not hasattr(engine, "ROUTER_SLICE")


def test_only_serving_under_a_mesh_names_slice_f():
    """Serving under a mesh is ported too: no module of the package, and
    not ``chip_smoke.py``, names ROADMAP Slice F."""
    naming = sorted(p.relative_to(SRC).as_posix()
                    for p in [*(SRC / "repro_torch").rglob("*.py"),
                              SRC.parent / "chip_smoke.py"]
                    if "Slice F" in p.read_text())
    assert naming == []


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = kan.KANSpec.single(4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kan.init(0, spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cf_kan.init(0, cf_kan_1.SMOKE_MODEL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kan.params_from_numpy({}, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kan_sam.collect_stats([], spec.asp[0], 4)
    lm = mamba2_1p3b.SMOKE.model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_model(0, lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.params_from_numpy({"stages": [{"embed": np.zeros(2)}]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_cache(lm, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_paged_cache(lm, 1, 8, page_size=4, n_pages=3)
    # the command lines: the card unless given --device cpu
    for main in (train_cf_kan.main, kan_neurosim_search.main,
                 quickstart.main, serve_kan_llm.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "mamba2_1p3b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "kan_llm", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "mixtral_8x7b", "--smoke", "--replicas",
                           "2", "--drift-replica", "1"])
    params = kan.init(0, spec, device="cpu")
    assert params["coeffs"].device.type == "cpu"
    lm_params = transformer.init_model(0, lm, device="cpu")
    assert lm_params["embed"].device.type == "cpu"
    # generate runs where its parameters lie: the CPU's plain versions here
    out = decode.generate(lm_params, lm, torch.zeros((1, 4), dtype=torch.long),
                          n_new=2)
    assert out.shape == (1, 2) and out.device.type == "cpu"
    # the engine: the card unless told, and then its cache lies there
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine(lm_params, lm, n_slots=1, max_len=8)
    eng = engine.Engine(lm_params, lm, n_slots=1, max_len=8, device="cpu")
    assert all(t.device.type == "cpu"
               for t in transformer.tree_leaves(eng.cache))
    out = decode.generate(lm_params, lm, [np.arange(3), np.arange(5)],
                          n_new=2)
    assert out.shape == (2, 2) and out.device.type == "cpu"


TINY_TRAIN = ["--items", "64", "--users", "128", "--hidden", "8", "--steps",
              "2", "--device", "cpu"]


def test_example_twins_run_end_to_end_on_the_cpu(capsys):
    """``--device cpu`` runs each example twin to its end: the training
    twin at a tiny size, the tuner twin and the quickstart at their own."""
    train_cf_kan.main(TINY_TRAIN)
    assert "Fig.19 cost model" in capsys.readouterr().out
    res = kan_neurosim_search.main(["--device", "cpu"])
    assert len(res.evaluated) == 16 and len(res.frontier) >= 1
    assert res.baseline.meta["origin"] == "baseline"
    assert "Pareto frontier" in capsys.readouterr().out
    out = quickstart.main(["--device", "cpu"])
    assert out["lut_vs_fused"] <= 1e-5 and out["err_sam"] < out["err_uniform"]
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_library_name_follows_the_headers(monkeypatch, tmp_path):
    """An edited header (``csrc/*.cuh``, which the sources include) names
    another library, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path()
    header = csrc / "cim_mac_common.cuh"
    assert '#include "cim_mac_common.cuh"' in (csrc / "cim_mac.cu").read_text()
    header.write_text(header.read_text() + "\n")
    assert build.library_path() != before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build only where the CUDA toolkit is; the library name
    follows the sources."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    path = build.library_path()
    assert path.parent == tmp_path and path.name.startswith("libkernels_")
    assert path == build.library_path()
    assert {p.name for p in build.CSRC.glob("*.cu")} == {
        "kan_fused.cu", "cim_mac.cu", "cim_mac_tiled.cu", "ssd_scan.cu",
        "kan_basis.cu"}
    if build.shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        build.load.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                build.load()
        finally:
            build.load.cache_clear()
