"""Port parity for checkpointing (``repro_torch.checkpoint``) and the
training launcher ``repro_torch.launch.train``: the cases of
``tests/test_checkpoint.py`` on the port (round trip, latest step, async
save, an interrupted write that stays invisible, dtype cast on restore),
checkpoints crossing between the packages in both directions (the same
layout and leaf keys), and the launcher's resume round trip in process
at SMOKE size (``tests/test_system.py``'s driver case). Restored leaves
must equal the saved ones bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as ttrain_launch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import make_optimizer, warmup_cosine  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((8, 4), generator=g),
                      "b": torch.zeros((4,))},
            "step_scalar": torch.tensor(3, dtype=torch.int32),
            "stages": [{"k": torch.ones((2, 3))}]}


def _equal(a, b):
    """Leaf for leaf by key path (dtype and bits)."""
    la, lb = ckpt._leaf_paths(a), ckpt._leaf_paths(b)
    assert set(la) == set(lb)
    for k, x in la.items():
        assert x.dtype == lb[k].dtype and torch.equal(x, lb[k]), k


def test_save_restore_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 10, tree, extra={"data_index": 99})
    restored, extra = ckpt.restore(str(tmp_path), tree)
    assert extra["data_index"] == 99
    _equal(tree, restored)
    with open(tmp_path / "step_00000010" / "manifest.json") as f:
        manifest = json.load(f)
    assert set(manifest) == {"step", "leaves", "treedef", "extra"}
    assert manifest["leaves"] == {"layer/b": "leaf_00000.npy",
                                  "layer/w": "leaf_00001.npy",
                                  "stages/0/k": "leaf_00002.npy",
                                  "step_scalar": "leaf_00003.npy"}


def test_latest_step_and_multiple(tmp_path):
    tree = _tree(1)
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, _ = ckpt.restore(str(tmp_path), tree, step=1)
    _equal(tree, restored)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_async_save_snapshots_before_returning(tmp_path):
    tree = _tree(2)
    want = tree["layer"]["w"].clone()
    t = ckpt.save_async(str(tmp_path), 7, tree)
    tree["layer"]["w"].add_(1.0)        # a later write is not saved
    t.join(timeout=30)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(restored["layer"]["w"], want)


def test_interrupted_write_is_invisible(tmp_path):
    """A .tmp dir (a writer that crashed mid-write) is never taken."""
    tree = _tree(3)
    ckpt.save(str(tmp_path), 3, tree)
    os.makedirs(str(tmp_path / "step_00000009.tmp"))
    os.makedirs(str(tmp_path / "step_00000011"))     # no manifest yet
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_dtype_cast_and_bf16_words_on_restore(tmp_path):
    tree = {"w": torch.ones((4,), dtype=torch.float32),
            "h": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), 0, tree)
    arr = np.load(tmp_path / "step_00000000" / "leaf_00000.npy")
    assert arr.dtype == np.dtype("V2")          # "h", as JAX stores bf16
    template = {"w": torch.zeros((4,), dtype=torch.bfloat16),
                "h": torch.zeros((3,), dtype=torch.bfloat16)}
    restored, _ = ckpt.restore(str(tmp_path), template)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["h"], tree["h"])


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone (a 1x1 mesh)."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_restore_onto_a_mesh(tmp_path, one_rank_group):
    """``restore(shardings=)``: a leaf with a ``NamedSharding`` comes back
    as a DTensor with those placements, a None one as a plain tensor, the
    values bitwise the saved ones."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from repro_torch.dist import sharding as tsh
    tree = _tree(4)
    ckpt.save(str(tmp_path / "ck"), 1, tree)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    rep = tsh.NamedSharding(mesh, (Replicate(), Replicate()))
    paths = ckpt._leaf_paths(tree)
    first = sorted(paths)[0]
    shardings = ckpt._rebuild(tree, {k: (rep if k == first else None)
                                     for k in paths})
    got, _ = ckpt.restore(str(tmp_path / "ck"), tree, shardings=shardings)
    for key, leaf in ckpt._leaf_paths(got).items():
        assert tsh.is_dtensor(leaf) == (key == first), key
        value = leaf.full_tensor() if tsh.is_dtensor(leaf) else leaf
        assert torch.equal(value, paths[key]), key


# --- across the packages -----------------------------------------------------

@pytest.fixture(scope="module")
def jck():
    jax = pytest.importorskip("jax")
    from repro.checkpoint import checkpoint
    from repro.configs import get_arch as jget
    from repro.models import transformer
    from repro.optim import make_optimizer as jmake, warmup_cosine as jwc
    return dict(jax=jax, ck=checkpoint, get_arch=jget, tfm=transformer,
                make_optimizer=jmake, warmup_cosine=jwc)


def _jax_tree(jck, name):
    """JAX's whisper SMOKE params and an adamw8 state after one update
    (int8 ``QTensor`` moments), as one (params, state) tree."""
    jax = jck["jax"]
    m = jck["get_arch"](name, smoke=True).model
    params = jck["tfm"].init_model(jax.random.PRNGKey(0), m)
    opt = jck["make_optimizer"]("adamw8", jck["warmup_cosine"](1e-3, 2, 10))
    grads = jax.tree.map(lambda p: p * 0.1, params)
    params, state = opt.update(grads, opt.init(params), params)
    return params, state


def test_jax_checkpoint_restores_into_the_port(tmp_path, jck):
    jax = jck["jax"]
    params, state = _jax_tree(jck, "whisper_base")
    jck["ck"].save(str(tmp_path), 4, (params, state), extra={"step": 4})
    m = get_arch("whisper_base", smoke=True).model
    tparams = ttfm.init_model(1, m, device="cpu")
    tstate = make_optimizer("adamw8", warmup_cosine(1e-3, 2, 10)).init(
        tparams)
    (rp, rs), extra = ckpt.restore(str(tmp_path), (tparams, tstate))
    assert extra == {"step": 4}
    want = ttfm.params_from_numpy(jax.tree.map(np.asarray, (params, state)),
                                  device="cpu")
    assert isinstance(rs["m"]["embed"], topt.QTensor)
    assert set(rp) >= {"enc_stages", "enc_final_norm", "dec_pos"}
    _equal(want, (rp, rs))


def test_port_checkpoint_restores_into_jax(tmp_path, jck):
    jax = jck["jax"]
    params, state = _jax_tree(jck, "whisper_base")
    port = ttfm.params_from_numpy(jax.tree.map(np.asarray, (params, state)),
                                  device="cpu")
    ckpt.save(str(tmp_path), 6, port, extra={"step": 6})
    zeros = jax.tree.map(lambda a: a * 0, (params, state))
    restored, extra = jck["ck"].restore(str(tmp_path), zeros)
    assert extra == {"step": 6}
    flat_r, tdef_r = jax.tree.flatten(restored)
    flat_w, tdef_w = jax.tree.flatten((params, state))
    assert tdef_r == tdef_w
    for a, b in zip(flat_r, flat_w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the same files and manifest keys as JAX's own save
    jck["ck"].save(str(tmp_path / "jax"), 6, (params, state))
    with open(tmp_path / "step_00000006" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax" / "step_00000006" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine["leaves"] == theirs["leaves"]


# --- the launcher ------------------------------------------------------------

def _launch(ck, steps, *extra):
    return ttrain_launch.main(
        ["--arch", "kan_llm", "--smoke", "--steps", str(steps), "--batch",
         "2", "--seq", "16", "--ckpt-dir", ck, "--save-every", "2",
         "--log-every", "1", "--kan-backend", "fused", "--device", "cpu",
         *extra])


def test_train_driver_resume_roundtrip(tmp_path, capsys):
    """4 steps with a save every 2, then a resume to 6: the resumed run
    starts at step 4 and its losses are an uninterrupted 6-step run's
    (all 6 steps lie in the schedule's 10-step warmup, which does not
    depend on ``--steps``)."""
    ck = str(tmp_path / "ck")
    first = _launch(ck, 4)
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert ckpt.latest_step(ck) == 4
    second = _launch(ck, 6)
    assert "resumed from step 4" in capsys.readouterr().out
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert ckpt.latest_step(ck) == 6
    straight = _launch(str(tmp_path / "straight"), 6)
    np.testing.assert_allclose(first["losses"], straight["losses"][:4],
                               rtol=1e-6)
    np.testing.assert_allclose(second["losses"], straight["losses"][4:],
                               rtol=1e-6)


def test_train_driver_preemption_checkpoints_and_stops(tmp_path,
                                                       monkeypatch):
    """A preemption flag set during the first step: one step runs, a
    synchronous checkpoint of step 1 is written, and the loop stops."""
    real = ttrain_launch.fault.PreemptionHandler

    class Preempted(real):
        @property
        def should_stop(self):
            return True
    monkeypatch.setattr(ttrain_launch.fault, "PreemptionHandler", Preempted)
    ck = str(tmp_path / "ck")
    out = _launch(ck, 5)
    assert len(out["losses"]) == 1 and ckpt.latest_step(ck) == 1


def test_host_mesh_and_model_parallel_flags(tmp_path, monkeypatch):
    """``--model-parallel`` without ``--host-mesh`` is ignored (the
    reference's launcher); ``--host-mesh`` joins the process group the
    environment describes (here one rank: a 1x1 mesh) and gives the
    unsharded losses; a model axis that does not divide the world is
    refused. ``test_torch_launch_mesh.py`` runs the launcher on 2x2."""
    argv = ["--arch", "kan_llm", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "8", "--kan-backend", "fused"]
    ref = ttrain_launch.main(argv)["losses"]
    assert ttrain_launch.main(argv + ["--model-parallel", "2"])[
        "losses"] == ref
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("REPRO_TORCH_STORE", str(tmp_path / "store"))
    got = ttrain_launch.main(argv + ["--host-mesh"])["losses"]
    assert got == pytest.approx(ref, rel=1e-5)
    monkeypatch.setenv("REPRO_TORCH_STORE", str(tmp_path / "store2"))
    with pytest.raises(ValueError, match="does not divide"):
        ttrain_launch.main(argv + ["--host-mesh", "--model-parallel", "2"])
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
