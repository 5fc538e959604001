"""Port parity for LM training: ``optim`` (AdamW, int8-moment AdamW,
Adafactor, the schedule and the clip) and ``train.make_train_step``
against the JAX package on the same numpy inputs, with JAX's weights and
optimizer states carried across (``transformer.params_from_numpy``,
``QTensor`` leaves included). ``transformer.loss_fn``'s parity is in
``test_torch_loss.py``.

Bars:
* optimizer updates on given gradients: ``atol 1e-6, rtol 1e-6`` on
  parameters and f32 state leaves (the same f32 operations; ``pow``,
  ``sqrt`` and ``rsqrt`` may round an ulp apart); ``adamw8``'s int8 codes
  equal JAX's but for at most 2% one step off (a value an ulp from a
  rounding boundary), and its scales at ``rtol 1e-6``;
* train steps: ``test_torch_loss.py``'s bars (``LOSS_BAR`` on the loss,
  ``atol 2e-5, rtol 1e-4`` on updated weights); accumulation 2
  against 1 is ``tests/test_train.py``'s ``rel 1e-5`` on the loss and
  ``atol 3e-4`` on the weights;
* two ``kan_llm`` SMOKE steps on ``fused``: the fused kernel's plain
  version and JAX's Pallas kernel (interpret mode) sum in different
  orders, so a KAN input an ulp from a level boundary can take the
  neighbouring code, which changes the gradients of the coefficients that
  code's basis rows reach. Losses are held at ``rtol 1e-5``; weights at
  ``atol 2e-5``, except at most 1% of a leaf's weights, which must stay
  within twice the peak lr (1e-3) of JAX's: Adam's step is about lr
  whatever the gradient's size, so a changed gradient moves a weight by up
  to that, and a wrong gradient everywhere would move far more than 1%.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_attention as ta  # noqa: E402
from test_torch_attention import jx  # noqa: E402,F401 (module fixture)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import optimizers as toptimizers  # noqa: E402
from repro_torch.train import train_step as ttrain  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_loss import LOSS_BAR, _lm_batch, _seq_for  # noqa: E402

UPD_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def jo():
    """JAX's optimizer and train-step modules."""
    pytest.importorskip("jax")
    from repro import optim
    from repro.train import train_step
    return optim, train_step


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "b": [rng.normal(size=(6,)).astype(np.float32)],
            "stack": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "s": np.float32(rng.normal())}


def _t(tree):
    return ttfm.params_from_numpy(tree, device="cpu")


def _hold_tree(jx, got, want, what, **tol):
    tol = tol or UPD_TOL
    for path, a, b in ta._walk(jx.jax.tree.map(np.asarray, want), got):
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
        if np.asarray(a).dtype == np.int8:
            _hold_codes(a, b, (what, path))
        else:
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64),
                                       err_msg=str((what, path)), **tol)


def _hold_codes(want, got, what):
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    assert diff.max() <= 1, what
    assert (diff > 0).mean() <= 0.02, what


@pytest.mark.parametrize("kind", ["adamw", "adamw8", "adafactor"])
def test_three_updates_match_jax(jx, jo, kind):
    """Three updates from one state on given gradients: params and every
    state leaf (``QTensor`` codes and scales too) after each."""
    jopt = jo[0].make_optimizer(kind, jo[0].warmup_cosine(1e-2, 2, 10))
    topt_ = topt.make_optimizer(kind, topt.warmup_cosine(1e-2, 2, 10))
    p_np = _tree(0)
    jp = jx.jax.tree.map(jx.jnp.asarray, p_np)
    js = jopt.init(jp)
    tp = _t(p_np)
    ts = topt_.init(tp)
    _hold_tree(jx, ts, js, "init")
    for k in range(3):
        g = _tree(10 + k)
        jp, js = jopt.update(jx.jax.tree.map(jx.jnp.asarray, g), js, jp)
        tp, ts = topt_.update(_t(g), ts, tp)
        _hold_tree(jx, tp, jp, ("params", k))
        _hold_tree(jx, ts, js, ("state", k))
    if kind == "adamw8":
        assert isinstance(ts["m"]["w"], topt.QTensor)
        assert ts["m"]["w"].codes.dtype == torch.int8
        # a JAX state carried across continues as the port's own
        ts2 = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, js),
                                     device="cpu")
        assert isinstance(ts2["v"]["stack"], topt.QTensor)
        g = _t(_tree(20))
        a, _ = topt_.update(g, ts2, tp)
        b, _ = topt_.update(g, ts, tp)
        for x, y in zip(toptimizers.tree_leaves(a),
                        toptimizers.tree_leaves(b)):
            assert torch.equal(x, y)


def test_q8_rounds_half_to_even_per_row(jx, jo):
    from repro.optim import optimizers as joptimizers
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0],
                  [1e-14, 0.0, -3.0, 2.0, 1.0]], np.float32)
    jq = joptimizers._q8(jx.jnp.asarray(x))
    tq = toptimizers._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-7)
    np.testing.assert_allclose(
        toptimizers._dq8(tq, x.shape).numpy(),
        np.asarray(joptimizers._dq8(jq, x.shape)), rtol=1e-7)


def test_warmup_cosine_and_clip_match_jax(jx, jo):
    jsched = jo[0].warmup_cosine(3e-4, 10, 80)
    tsched = topt.warmup_cosine(3e-4, 10, 80)
    for s in (0, 1, 5, 9, 10, 11, 40, 79, 80, 100):
        want = float(jsched(jx.jnp.asarray(s, jx.jnp.int32)))
        got = float(tsched(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
    assert float(tsched(torch.tensor(0))) == 0.0
    assert float(tsched(torch.tensor(80))) == pytest.approx(3e-5, rel=1e-5)
    for max_norm in (1.0, 1e3):
        t = _tree(3)
        jc, jn = jo[0].clip_by_global_norm(
            jx.jax.tree.map(jx.jnp.asarray, t), max_norm)
        tc, tn = topt.clip_by_global_norm(_t(t), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        _hold_tree(jx, tc, jc, ("clip", max_norm))
    tree = {"a": torch.ones(4) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = topt.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# --- the train step ----------------------------------------------------------

def _step_pair(jx, jo, name, accum, seed=2, steps=1, **over):
    jm, tm, jp, tp = ta._model(jx, name, "f32", seed=seed, **over)
    jopt = jo[0].make_optimizer("adamw", jo[0].warmup_cosine(1e-3, 2, 10))
    tops_ = topt.make_optimizer("adamw", topt.warmup_cosine(1e-3, 2, 10))
    jstep = jx.jax.jit(jo[1].make_train_step(jm, jopt, jo[1].TrainConfig(
        accum_steps=accum)))
    tstep = ttrain.make_train_step(tm, tops_, ttrain.TrainConfig(
        accum_steps=accum))
    js, ts = jopt.init(jp), tops_.init(tp)
    out = []
    for k in range(steps):
        b = _lm_batch(jm, b=4, s=_seq_for(jm), seed=seed + k)
        jp, js, jmet = jstep(jp, js, {k_: jx.jnp.asarray(v)
                                      for k_, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, b)
        out.append((jp, js, jmet, tp, ts, tmet))
    return out


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "whisper_base",
                                  "mamba2_1p3b"])
def test_train_step_matches_jax(jx, jo, name):
    """One AdamW step (accumulation 2) from JAX's weights and a fresh
    state: loss, grad norm, weights and moments as JAX's."""
    ((jp, js, jmet, tp, ts, tmet),) = _step_pair(jx, jo, name, accum=2)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_BAR
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-3)
    _hold_tree(jx, tp, jp, "params", atol=2e-5, rtol=1e-4)
    assert int(ts["step"]) == int(js["step"]) == 1


def test_accumulation_equals_one_microbatch(jx, jo):
    """accum 2 gives accum 1's update on the same batch (the JAX suite's
    ``test_grad_accumulation_equivalence``)."""
    tm = tconfigs.get_arch("mistral_nemo_12b", smoke=True).model
    tp = ttfm.init_model(0, tm, device="cpu")
    b = _lm_batch(tm, b=8, s=12)
    res = []
    for accum in (1, 2):
        o = topt.make_optimizer("adamw", lambda s: torch.tensor(1e-3))
        step = ttrain.make_train_step(tm, o, ttrain.TrainConfig(
            accum_steps=accum))
        res.append(step(tp, o.init(tp), b))
    (p1, _, m1), (p2, _, m2) = res
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b_ in zip(toptimizers.tree_leaves(p1),
                     toptimizers.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=3e-4)
    # the input tree is left as it was
    assert all(not t.requires_grad for t in toptimizers.tree_leaves(tp))


def test_two_kan_llm_fused_steps_match_jax(jx, jo):
    """``kan_llm`` SMOKE on ``fused`` (the training forward through the
    fused kernel's autograd Function): two AdamW steps against JAX's."""
    out = _step_pair(jx, jo, "kan_llm", accum=1, seed=3, steps=2,
                     kan_backend="fused")
    for k, (jp, js, jmet, tp, ts, tmet) in enumerate(out):
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5), k
        for path, a, b in ta._walk(jx.jax.tree.map(np.asarray, jp), tp):
            d = np.abs(b.numpy().astype(np.float64) - a)
            assert (d > 2e-5).mean() <= 0.01, (k, path)
            assert d.max() <= 2e-3, (k, path, d.max())
    assert not math.isclose(float(out[0][5]["loss"]),
                            float(out[1][5]["loss"]))
