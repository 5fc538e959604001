"""Port parity for ``transformer.loss_fn`` against the JAX package on the
same numpy inputs, with JAX's weights carried across
(``transformer.params_from_numpy``): a dense LM, a MoE, the
encoder-decoder and the SSM at their SMOKE sizes, on both ``ce_impl``
paths, with and without a ``loss_mask``, values and gradients.

Bars: the JAX serving suite's ``2e-4`` on the loss (as on logits,
``test_torch_attention.py``) and ``atol 2e-4, rtol 1e-3`` on every
gradient leaf (backward f32 sums in another order; the suite's forward
bar, with a relative part for the embedding's summed rows).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_attention as ta  # noqa: E402
from test_torch_attention import jx  # noqa: E402,F401 (module fixture)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import lm_synth  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import optimizers as toptimizers  # noqa: E402
from repro_torch.train import train_step as ttrain  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

LOSS_BAR = 2e-4
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


# --- batches -----------------------------------------------------------------

def _lm_batch(jm, b=2, s=12, seed=0, mask=False):
    d = lm_synth.batch_at(lm_synth.LMDataConfig(vocab=jm.vocab, batch=b,
                                                seq_len=s, seed=seed), 0)
    out = {"tokens": d["tokens"], "labels": d["labels"]}
    if jm.frontend == "audio_stub":
        out["frames"] = np.random.default_rng(seed).normal(
            size=(b, 10, jm.d_model)).astype(np.float32)
    if mask:
        m = np.ones((b, s), np.float32)
        m[0, :5] = 0.0
        m[1, -3:] = 0.0
        out["loss_mask"] = m
    return out


def _seq_for(jm):
    """12 positions; an SSM gets 40, three chunks of its SMOKE 16 with the
    last one partial, so the gradient crosses the carried state."""
    return 40 if jm.family == "ssm" else 12


# --- loss_fn ---------------------------------------------------------------

def _grad_case(jx, name, ce_impl, mask, seed):
    jm, tm, jp, tp = ta._model(jx, name, "f32", seed=seed, ce_impl=ce_impl)
    b = _lm_batch(jm, s=_seq_for(jm), seed=seed, mask=mask)
    (jl, jmet), jg = jx.jax.jit(
        jx.jax.value_and_grad(jx.tfm.loss_fn, has_aux=True),
        static_argnums=1)(jp, jm, {k: jx.jnp.asarray(v) for k, v in b.items()})
    tl, tmet, tg = ttrain.value_and_grad(
        ttfm.loss_fn, tp, tm, {k: torch.from_numpy(v) for k, v in b.items()})
    return jl, jmet, jg, tl, tmet, tg


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("ce_impl", ["gather", "onehot"])
@pytest.mark.parametrize("name", ["mistral_nemo_12b", "mixtral_8x7b",
                                  "whisper_base", "mamba2_1p3b"])
def test_loss_fn_values_and_gradients_match_jax(jx, name, ce_impl, mask):
    jl, jmet, jg, tl, tmet, tg = _grad_case(jx, name, ce_impl, mask, seed=1)
    assert abs(float(tl) - float(jl)) <= LOSS_BAR
    for k in ("ce", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_BAR, k
    if name == "mixtral_8x7b":
        assert float(tmet["aux"]) > 0          # MoE's aux losses count
    assert float(tl) == pytest.approx(float(tmet["ce"] + tmet["aux"]))
    n = 0
    for path, a, b in ta._walk(jx.jax.tree.map(np.asarray, jg), tg):
        np.testing.assert_allclose(b.numpy(), a, err_msg=str(path),
                                   **GRAD_TOL)
        n += 1
    assert n == len(toptimizers.tree_leaves(tg))


def test_loss_mask_selects_positions():
    """A mask that keeps one position gives that position's CE alone."""
    tm = tconfigs.get_arch("mistral_nemo_12b", smoke=True).model
    tp = ttfm.init_model(0, tm, device="cpu")
    d = lm_synth.batch_at(lm_synth.LMDataConfig(vocab=tm.vocab, batch=2,
                                                seq_len=8), 0)
    b = {k: torch.from_numpy(v) for k, v in d.items()}
    mask = torch.zeros((2, 8))
    mask[1, 3] = 1.0
    with torch.no_grad():
        loss, met = ttfm.loss_fn(tp, tm, dict(b, loss_mask=mask))
        logits, _ = ttfm.forward(tp, tm, b)
    want = -torch.log_softmax(logits[1, 3].float(), -1)[b["labels"][1, 3]]
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
