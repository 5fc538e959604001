"""Port parity for training under a mesh: one train step on 2x2 gloo
ranks on the CPU (``test_torch_mesh_ranks``) against the unsharded port
and against JAX under the same mesh shape, and the elastic checkpoint
(save on 2x2, ``restore(shardings=)`` on 1x2).

* ``kan_llm`` (KAN-FFN on the ``fused`` backend, through
  ``ops.kan_spline_fused`` under ``local_map``) and mamba2 (``ssd`` under
  ``local_map``) SMOKE: loss and gradient norm within ``1e-5`` relative of
  the unsharded step on the same parameters and batch, every gradient
  within ``rtol 1e-5`` plus ``1e-6`` of its leaf's largest, and every
  updated leaf within ``1e-4``. AdamW's first step moves an entry by
  ``lr * g / (|g| + eps)``: about the learning rate (5e-3) wherever |g|
  is well above eps = 1e-8, but a steep function of g where a gradient
  entry sums to near zero (an embedding row that only the unembedding
  touches), so the leaves' bar is wider than the gradients'.
* mixtral SMOKE with JAX's parameters packed for 2 model shards: loss,
  gradient norm and updated leaves against JAX's jitted step under the
  same (data 2, model 2) mesh, at the same bars.
* The checkpoint written from 2x2 DTensors restores onto 1x2 with the
  target placements, every leaf bitwise equal to what was saved.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_mesh_ranks import run_ranks  # noqa: E402

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import lm_synth  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import make_optimizer, warmup_cosine  # noqa: E402
from repro.train.train_step import TrainConfig, make_train_step  # noqa: E402

REL = 1e-5
LEAF_ATOL = 1e-4


def _batch(vocab):
    b = lm_synth.batch_at(lm_synth.LMDataConfig(vocab=vocab, batch=4,
                                                seq_len=16), 0)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    jm = jget_arch("mixtral_8x7b", smoke=True).model
    params = jtfm.init_model(jax.random.PRNGKey(0), jm, n_model=2)
    pnp = jax.tree.map(np.asarray, params)
    archs = [
        {"arch": "kan_llm", "kan_backend": "fused", "model": 2,
         "batch": _batch(256)},
        {"arch": "mamba2_1p3b", "model": 2, "batch": _batch(
            jget_arch("mamba2_1p3b", smoke=True).model.vocab)},
        {"arch": "mixtral_8x7b", "model": 2, "batch": _batch(jm.vocab),
         "params": pnp, "unsharded": False},
    ]
    out = run_ranks("train", 4, tmp_path_factory.mktemp("train"),
                    {"archs": archs})
    # JAX's step for mixtral under the same mesh
    opt = make_optimizer("adamw", warmup_cosine(1e-2, 2, 10))
    step = jax.jit(make_train_step(jm, opt, TrainConfig()))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with mesh:
        p1, _, met = step(params, opt.init(params),
                          {k: jnp.asarray(v) for k, v in archs[2][
                              "batch"].items()})
    jref = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
            "leaves": {k: np.asarray(v)
                       for k, v in jckpt._leaf_paths(p1).items()}}
    return out, jref


def _close(a, b):
    assert abs(a - b) <= REL * abs(b), (a, b)


@pytest.mark.parametrize("arch", ["kan_llm", "mamba2_1p3b"])
def test_mesh_step_equals_unsharded(steps, arch):
    out, _ = steps
    for res in out:
        r = res[arch]
        _close(r["mesh"]["loss"], r["plain"]["loss"])
        _close(r["mesh"]["gnorm"], r["plain"]["gnorm"])
        for k, b in r["plain"]["grads"].items():
            np.testing.assert_allclose(r["mesh"]["grads"][k], b, rtol=REL,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=k)
        for k, b in r["plain"]["leaves"].items():
            np.testing.assert_allclose(r["mesh"]["leaves"][k], b, rtol=0,
                                       atol=LEAF_ATOL, err_msg=k)


def test_mixtral_mesh_step_equals_jax(steps):
    out, jref = steps
    for res in out:
        r = res["mixtral_8x7b"]["mesh"]
        _close(r["loss"], jref["loss"])
        _close(r["gnorm"], jref["gnorm"])
        assert sorted(r["leaves"]) == sorted(jref["leaves"])
        for k, b in jref["leaves"].items():
            np.testing.assert_allclose(r["leaves"][k], b, rtol=0,
                                       atol=LEAF_ATOL, err_msg=k)


def test_mesh_ranks_agree(steps):
    out, _ = steps
    for arch in out[0]:
        for res in out[1:]:
            assert res[arch]["mesh"]["loss"] == out[0][arch]["mesh"]["loss"]


def test_checkpoint_2x2_restores_on_1x2_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    saved = run_ranks("ckpt_save", 4, tmp_path, {"dir": d})
    got = run_ranks("ckpt_restore", 2, tmp_path, {"dir": d})
    for res in got:
        assert res["step"] == 5
        assert len(res["leaves"]) == len(saved[0]["leaves"])
        for a, b in zip(res["leaves"], saved[0]["leaves"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # on 1x2 the "embed" dims replicate and "vocab"/"mlp" split in two
    assert got[0]["placements"][0] == ["R", "S(0)"]      # embed table
    assert got[0]["local_shapes"][0] == (128, 64)        # 256 / 2 rows
