"""Port parity for the slice as a whole: CF-KAN served through ``fused`` and
``cim`` (uniform and KAN-SAM) in both packages.

JAX-initialised params are carried across with ``params_from_numpy``; both
packages deploy their own artifact and score the same ``cf_synth`` users
(the port's generator is a copy of the reference's, so the same seed gives
the same data). Each package collects its own Phase-A stats, and those are
compared allclose: their sums are taken in another order, and on rows whose
basis value is constant the variance ``E[b^2] - E[b]^2`` is pure cancellation
noise, which moves the criticality of the encoder's rows. The KAN-SAM
variant therefore deploys both packages from the JAX stats, carried across.

Tolerances: the encoder of both packages sees identical inputs. The
decoder's inputs pass through ``tanh``, whose XLA and PyTorch CPU versions
may differ by an ulp, and through f32 sums taken in another order; a
decoder input that lands within that distance of a quantisation cell edge
would take the neighbouring code. The test counts those codes and, with
none differing, holds the scores to atol 2e-5 / rtol 1e-5 (fused, lut) and
atol 2e-3 / rtol 1e-4 (cim, whose ADC readouts agree when the codes do).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import cf_kan_1 as jc1, cf_kan_2 as jc2  # noqa: E402
from repro.core import kan as jk, quant as jq  # noqa: E402
from repro.data import cf_synth as jsyn  # noqa: E402
from repro.hw import cim as jcim  # noqa: E402
from repro.models import cf_kan as jcf  # noqa: E402
from repro_torch.configs import cf_kan_1 as tc1, cf_kan_2 as tc2  # noqa: E402
from repro_torch.core import kan as tk, kan_sam as tsam  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.data import cf_synth as tsyn  # noqa: E402
from repro_torch.hw import cim as tcim  # noqa: E402
from repro_torch.models import cf_kan as tcf  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

N_ITEMS, HIDDEN = 128, 16
CIM = dict(array_size=256, gamma0=0.08)
TOL = {"lut": (2e-5, 1e-5), "fused": (2e-5, 1e-5), "cim": (2e-3, 1e-4),
       "cim_sam": (2e-3, 1e-4)}


@pytest.fixture(scope="module")
def slice_setup():
    cfg_j = dataclasses.replace(jc1.SMOKE_MODEL, n_items=N_ITEMS,
                                hidden=HIDDEN)
    cfg_t = dataclasses.replace(tc1.SMOKE_MODEL, n_items=N_ITEMS,
                                hidden=HIDDEN)
    params_j = jcf.init(jax.random.PRNGKey(0), cfg_j)
    params_t = tk.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    "cpu")
    ds = jsyn.generate(n_users=192, n_items=N_ITEMS, seed=0)
    stats_batches = [ds.observed[:64], ds.observed[64:128]]
    stats_j = jcf.collect_layer_stats(
        params_j, [jnp.asarray(b) for b in stats_batches], cfg_j)
    stats_t = tcf.collect_layer_stats(
        params_t, [torch.from_numpy(b) for b in stats_batches], cfg_t)
    stats_carried = {k: tsam.BasisStats(
        cnt=torch.from_numpy(np.array(v.cnt)),
        s1=torch.from_numpy(np.array(v.s1)),
        s2=torch.from_numpy(np.array(v.s2)), n_samples=v.n_samples)
        for k, v in stats_j.items()}
    x, held = ds.observed[128:], ds.held_out[128:]
    scores = {}
    for variant in TOL:
        kw_j, kw_t = {}, {}
        if variant.startswith("cim"):
            kw_j = dict(cim_cfg=jcim.CIMConfig(**CIM))
            kw_t = dict(cim_cfg=tcim.CIMConfig(**CIM))
            if variant == "cim_sam":
                kw_j.update(use_sam=True, stats=stats_j)
                kw_t.update(use_sam=True, stats=stats_carried)
        backend = variant if not variant.startswith("cim") else "lut"
        dep_j = jcf.deploy(params_j, dataclasses.replace(cfg_j,
                                                         backend=backend),
                           **kw_j)
        dep_t = tcf.deploy(params_t, dataclasses.replace(cfg_t,
                                                         backend=backend),
                           **kw_t)
        scores[variant] = (np.asarray(jk.apply(dep_j, jnp.asarray(x))),
                           tk.apply(dep_t, torch.from_numpy(x)))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, ds=ds, x=x, held=held, stats_j=stats_j,
                stats_t=stats_t, stats_carried=stats_carried, scores=scores)


def test_cf_synth_is_the_same_data():
    a = jsyn.generate(n_users=64, n_items=96, seed=5)
    b = tsyn.generate(n_users=64, n_items=96, seed=5)
    np.testing.assert_array_equal(a.observed, b.observed)
    np.testing.assert_array_equal(a.held_out, b.held_out)
    tr_a, va_a = jsyn.split(a)
    tr_b, va_b = tsyn.split(b)
    np.testing.assert_array_equal(va_a.observed, va_b.observed)
    for ba, bb in zip(jsyn.batches(tr_a, 16, seed=1),
                      tsyn.batches(tr_b, 16, seed=1)):
        np.testing.assert_array_equal(ba, bb)


def test_decoder_input_codes_agree(slice_setup):
    """Count decoder-input codes that differ between the packages (tanh and
    summation order); at this size and seed there are none."""
    s = slice_setup
    enc_j = jk.KANSpec.single(N_ITEMS, HIDDEN, s["cfg_j"].asp_enc)
    enc_t = tk.KANSpec.single(N_ITEMS, HIDDEN, s["cfg_t"].asp_enc)
    h_j = jk.apply(jk.deploy(s["params_j"]["enc"], enc_j), jnp.asarray(s["x"]))
    h_t = tk.apply(tk.deploy(s["params_t"]["enc"], enc_t),
                   torch.from_numpy(s["x"]))
    q_j = np.asarray(jq.quantize_input(
        jk.bound_input(h_j, s["cfg_j"].asp_dec), s["cfg_j"].asp_dec))
    q_t = tq.quantize_input(tk.bound_input(h_t, s["cfg_t"].asp_dec),
                            s["cfg_t"].asp_dec).numpy()
    assert q_t.shape == (64, HIDDEN)
    assert int((q_j != q_t).sum()) == 0


@pytest.mark.parametrize("variant", list(TOL))
def test_scores_match(slice_setup, variant):
    want, got = slice_setup["scores"][variant]
    assert got.shape == (64, N_ITEMS)
    assert bool(torch.isfinite(got).all())
    atol, rtol = TOL[variant]
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("variant", list(TOL))
def test_recall_and_ndcg_match(slice_setup, variant):
    """Same top-20 lists, hence the same Recall@20 and NDCG@20 (the means
    are compared at f32 rounding of the final average)."""
    s = slice_setup
    want, got = s["scores"][variant]
    xj, hj = jnp.asarray(s["x"]), jnp.asarray(s["held"])
    xt, ht = torch.from_numpy(s["x"]), torch.from_numpy(s["held"])
    top_j = np.asarray(jax.lax.top_k(
        jnp.where(xj > 0, -jnp.inf, jnp.asarray(want)), 20)[1])
    np.testing.assert_array_equal(tcf._top_k(got, xt, 20).numpy(), top_j)
    r_j = float(jcf.recall_at_k(jnp.asarray(want), hj, xj))
    r_t = float(tcf.recall_at_k(got, ht, xt))
    n_j = float(jcf.ndcg_at_k(jnp.asarray(want), hj, xj))
    n_t = float(tcf.ndcg_at_k(got, ht, xt))
    assert r_t == pytest.approx(r_j, rel=1e-6, abs=1e-7)
    assert n_t == pytest.approx(n_j, rel=1e-6, abs=1e-7)
    assert r_t > 0


def test_metric_ties_break_by_lower_index():
    scores = torch.zeros((1, 30))
    held = torch.zeros((1, 30))
    held[0, :20] = 1.0
    observed = torch.zeros((1, 30))
    assert float(tcf.recall_at_k(scores, held, observed)) == 1.0
    assert float(tcf.ndcg_at_k(scores, held, observed)) == pytest.approx(1.0)


def test_collect_layer_stats_match(slice_setup):
    s = slice_setup
    for name in ("enc", "dec"):
        sj, st = s["stats_j"][name], s["stats_t"][name]
        assert st.n_samples == sj.n_samples == 128
        np.testing.assert_array_equal(st.cnt.numpy(), np.asarray(sj.cnt))
        np.testing.assert_allclose(st.s1.numpy(), np.asarray(sj.s1),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(st.s2.numpy(), np.asarray(sj.s2),
                                   rtol=1e-6, atol=1e-5)


def test_training_forward_matches(slice_setup):
    s = slice_setup
    want = jcf.apply(s["params_j"], jnp.asarray(s["x"]), s["cfg_j"])
    got = tcf.apply(s["params_t"], torch.from_numpy(s["x"]), s["cfg_t"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_apply_cim_wrapper(slice_setup):
    s = slice_setup
    got = tcf.apply_cim(s["params_t"], torch.from_numpy(s["x"]), s["cfg_t"],
                        tcim.CIMConfig(**CIM), use_sam=True,
                        stats=s["stats_carried"])
    np.testing.assert_array_equal(got.numpy(),
                                  s["scores"]["cim_sam"][1].numpy())


def test_param_counts():
    assert tc1.MODEL.n_params == 38_928_384 == jc1.MODEL.n_params
    assert tc2.MODEL.n_params == 62_881_792 == jc2.MODEL.n_params
    assert tc1.SMOKE_MODEL.n_params == jc1.SMOKE_MODEL.n_params
    assert tc2.SMOKE_MODEL.n_params == jc2.SMOKE_MODEL.n_params
