"""Port parity for the training slice: QAT through ``kan.train_apply``, the
fused kernel's autograd Function ``ops.kan_spline_fused``, CF-KAN's
``multinomial_loss`` and the SGD script ``repro_torch.examples.train_cf_kan``
against the JAX package (Pallas in interpret mode) on the same numpy inputs.

* The Function's d/dcoeffs is the quantised expanded basis times dy
  (``test_kernels.py:54``'s convention) and equals ``jax.vjp`` of
  ``ops.kan_spline_fused``, at ``atol 1e-5, rtol 1e-5``; its d/dx is the
  float cardinal path's derivative, equal to ``jax.vjp``'s at the same bar,
  on inputs that sit on knots too (there ``jnp.clip`` passes half the
  gradient, and so does ``splines.locate``).
* ``train_apply(qat=True)`` equals the deployed integer forward (``ref``,
  ``lut``, ``fused``; ``cim`` and ``cim_tiled`` train on the LUT path, so
  theirs is held to the deployed digital forward of the same artifact) at
  ``test_kan_backends.py:84``'s ``atol 2e-5, rtol 1e-5``, and JAX's
  ``train_apply(qat=True)``.
* Gradients of the whole param tree, QAT and (for ``fused``, the repaired
  fault) without, equal ``jax.grad``'s at ``atol 1e-5, rtol 1e-5``.
* Five SGD steps of the script's ``train`` at SMOKE width (256 items, hidden
  16) from JAX's weights, held to the JAX example's losses (``rtol 1e-6``)
  and weights (``atol 1e-5``) step for step. On ``lut`` no decoder input
  code differs between the packages and the weights agree to 1e-8; on
  ``fused`` the two kernels' f32 sums move 12 of the 13,104 decoder input
  codes of the training users at step 4 (15 at step 5), which moves the
  decoder's coefficients by up to 5.4e-6 at step 5. No more than 0.5% of
  the codes may differ.
* ``cuda`` cases run the Function on the card at CF-KAN-1's shapes and batch
  64 against float64 formulas; they import no JAX.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cf_kan_1  # noqa: E402
from repro_torch.core import kan as tk, quant as tq  # noqa: E402
from repro_torch.core import splines as ts  # noqa: E402
from repro_torch.data import cf_synth  # noqa: E402
from repro_torch.examples import train_cf_kan as ttrain  # noqa: E402
from repro_torch.hw import chip as tchip, cim as tcim  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cf_kan as tcf  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
BACKENDS = ("ref", "lut", "fused", "cim", "cim_tiled")
CIM = dict(array_size=64, gamma0=0.08)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import kan as jk, quant as jq
    from repro.hw import chip as jchip, cim as jcim
    from repro.kernels import ops as jops
    from repro.models import cf_kan as jcf
    return types.SimpleNamespace(jax=jax, jnp=jnp, kan=jk, quant=jq,
                                 ops=jops, cf=jcf, cim=jcim, chip=jchip)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


def _function_case(g, knots, seed=3):
    """x [9, 7] in (-0.9, 0.9), or drawn from the knots of grid G (range
    ends included); coeffs [7, G+3, 4]; dy [9, 4]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (9, 7)).astype(np.float32)
    if knots:
        x = rng.choice(np.linspace(-1, 1, g + 1).astype(np.float32), (9, 7))
    c = rng.normal(size=(7, g + 3, 4)).astype(np.float32)
    dy = rng.normal(size=(9, 4)).astype(np.float32)
    return x, c, dy


def _port_vjp(x, c, dy, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    ct = torch.from_numpy(c).to(dtype).requires_grad_()
    y = tops.kan_spline_fused(xt, ct, tq.ASPConfig(grid_size=g))
    y.backward(torch.from_numpy(dy).to(dtype))
    return y.detach(), xt.grad, ct.grad


@pytest.mark.parametrize("g,knots", [(5, False), (8, False), (8, True)])
def test_fused_function_vjp_matches_jax(jx, g, knots):
    x, c, dy = _function_case(g, knots)
    cfg = jx.quant.ASPConfig(grid_size=g)
    y_j, vjp = jx.jax.vjp(lambda xx, cc: jx.ops.kan_spline_fused(xx, cc, cfg),
                          jx.jnp.asarray(x), jx.jnp.asarray(c))
    dx_j, dc_j = vjp(jx.jnp.asarray(dy))
    y, dx, dc = _port_vjp(x, c, dy, g)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **GRAD_TOL)
    np.testing.assert_allclose(dc.numpy(), np.asarray(dc_j), **GRAD_TOL)
    # d/dcoeffs is the quantised expanded basis times dy (the QAT convention)
    eq = jx.quant.quantized_basis(jx.jnp.asarray(x), jx.quant.hemi_for(cfg),
                                  cfg)
    want_dc = np.einsum("bis,bo->iso", np.asarray(eq), dy)
    np.testing.assert_allclose(dc.numpy(), want_dc, **GRAD_TOL)
    if knots:   # every input on a knot: the clip's half gradient counts
        u = ts.locate(torch.from_numpy(x), -1.0, 1.0, g)[1]
        assert bool(((u == 0) | (u == 1)).all())


@pytest.mark.parametrize("g,knots", [(5, False), (8, False), (8, True)])
def test_float64_dx_oracle_matches_function(g, knots):
    """``ref.kan_spline_dx_f64``, the float64 d/dx that the card's checks
    hold the Function to, equals the Function's d/dx on the CPU at
    ``atol 1e-5, rtol 1e-5``, on knots too; its mass bounds |d/dx|."""
    x, c, dy = _function_case(g, knots)
    want, mass = tref.kan_spline_dx_f64(
        torch.from_numpy(x), torch.from_numpy(c), tq.ASPConfig(grid_size=g),
        torch.from_numpy(dy))
    assert want.dtype == mass.dtype == torch.float64
    np.testing.assert_allclose(_port_vjp(x, c, dy, g)[1].numpy(),
                               want.numpy(), **GRAD_TOL)
    assert bool((want.abs() <= mass * (1 + 1e-12)).all())


def test_fused_function_skips_dx_of_data():
    """An input that needs no gradient (an encoder's data) gets none, and
    the coefficients' gradient is unchanged by that."""
    x, c, dy = _function_case(5, False)
    ct = torch.from_numpy(c).requires_grad_()
    y = tops.kan_spline_fused(torch.from_numpy(x), ct,
                              tq.ASPConfig(grid_size=5))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(ct.grad.numpy(),
                                  _port_vjp(x, c, dy, 5)[2].numpy())


def test_fused_function_bf16(jx):
    """bf16 x and coeffs come back in bf16, forward and gradients
    (``test_kernels.py:41``): the input's bf16 rounding may move codes by a
    cell, so the forward is held loosely to the f32 one, and to JAX's bf16
    forward within two bf16 steps of its largest output."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    c = rng.normal(size=(8, 8, 8)).astype(np.float32)
    dy = rng.normal(size=(16, 8)).astype(np.float32)
    y32 = _port_vjp(x, c, dy, 5)[0]
    ybf, dxbf, dcbf = _port_vjp(x, c, dy, 5, torch.bfloat16)
    assert ybf.dtype == dxbf.dtype == dcbf.dtype == torch.bfloat16
    assert float((ybf.float() - y32).abs().mean()) < 0.3
    bf = jx.jnp.bfloat16
    y_j = jx.ops.kan_spline_fused(jx.jnp.asarray(x).astype(bf),
                                  jx.jnp.asarray(c).astype(bf),
                                  jx.quant.ASPConfig(grid_size=5))
    y_j = np.asarray(y_j.astype(jx.jnp.float32))
    step = 2 ** -7 * np.abs(y_j).max()
    np.testing.assert_allclose(ybf.float().numpy(), y_j, atol=2 * step)


def _single(jx, backend, seed=4):
    """One 16 -> 8 layer (G=8) from JAX's init, 32 inputs in (-1, 1), as
    ``test_kan_backends.py``'s set-up; ``cim`` at As 64, ``cim_tiled`` on
    its default chip."""
    key = jx.jax.random.PRNGKey(seed)
    spec_j = jx.kan.KANSpec.single(16, 8, jx.quant.ASPConfig(grid_size=8))
    params_j = jx.kan.init(key, spec_j)
    x = np.array(jx.jax.random.uniform(jx.jax.random.fold_in(key, 1),
                                       (32, 16), minval=-1, maxval=1))
    spec_t = tk.KANSpec.single(16, 8, tq.ASPConfig(grid_size=8))
    extra_j = {"cim": dict(cim=jx.cim.CIMConfig(**CIM)),
               "cim_tiled": dict(cim=jx.chip.ChipConfig())}
    extra_t = {"cim": dict(cim=tcim.CIMConfig(**CIM)),
               "cim_tiled": dict(cim=tchip.ChipConfig())}
    return (spec_j.with_backend(backend, **extra_j.get(backend, {})),
            spec_t.with_backend(backend, **extra_t.get(backend, {})),
            params_j, tk.params_from_numpy(_np(params_j), "cpu"), x)


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_apply_qat_equals_deployed_and_jax(jx, backend):
    spec_j, spec_t, params_j, params_t, x = _single(jx, backend)
    xt = torch.from_numpy(x)
    y_train = tk.train_apply(params_t, xt, spec_t, qat=True)
    digital = backend if backend in ("ref", "lut", "fused") else "lut"
    y_dep = tk.apply(tk.deploy(params_t, spec_t.with_backend(digital,
                                                             cim=None)), xt)
    np.testing.assert_allclose(y_train.detach().numpy(), y_dep.numpy(),
                               **FWD_TOL)
    want = jx.kan.train_apply(params_j, jx.jnp.asarray(x), spec_j, qat=True)
    np.testing.assert_allclose(y_train.detach().numpy(), np.asarray(want),
                               **FWD_TOL)


def test_qat_requantisation_keeps_codes(jx):
    """Under QAT the fused Function quantises coefficients that are already
    fake-quantised: the codes come back unchanged, and equal JAX's on the
    same path (the scale may move by an ulp, as in JAX)."""
    spec_j, spec_t, params_j, params_t, _ = _single(jx, "fused")
    asp_t, asp_j = spec_t.asp[0], spec_j.asp[0]
    c = params_t["coeffs"]
    codes, scale = tq.quantize_coeffs(c, asp_t, axis=(0, 1))
    cq = c + (tq.dequantize_coeffs(codes, scale) - c)
    codes2, scale2 = tq.quantize_coeffs(cq, asp_t, axis=(0, 1))
    assert torch.equal(codes2, codes)
    np.testing.assert_allclose(scale2.numpy(), scale.numpy(), rtol=2e-7)
    cj = params_j["coeffs"]
    codes_j, scale_j = jx.quant.quantize_coeffs(cj, asp_j, axis=(0, 1))
    cqj = cj + (jx.quant.dequantize_coeffs(codes_j, scale_j) - cj)
    codes2_j, scale2_j = jx.quant.quantize_coeffs(cqj, asp_j, axis=(0, 1))
    np.testing.assert_array_equal(codes2.numpy(), np.asarray(codes2_j))
    np.testing.assert_array_equal(scale2.numpy(), np.asarray(scale2_j))


def _two_layer(jx, backend):
    """12 -> 10 -> 6 (G=7) from JAX's init, 40 inputs, the decoder's input
    an encoder output (so d/dx reaches the first layer)."""
    spec_j = jx.kan.KANSpec(dims=(12, 10, 6),
                            asp=(jx.quant.ASPConfig(grid_size=7),))
    spec_t = tk.KANSpec(dims=(12, 10, 6), asp=(tq.ASPConfig(grid_size=7),))
    extra_j = {"cim": dict(cim=jx.cim.CIMConfig(**CIM)),
               "cim_tiled": dict(cim=jx.chip.ChipConfig())}
    extra_t = {"cim": dict(cim=tcim.CIMConfig(**CIM)),
               "cim_tiled": dict(cim=tchip.ChipConfig())}
    params_j = jx.kan.init(jx.jax.random.PRNGKey(3), spec_j)
    x = np.random.default_rng(3).normal(size=(40, 12)).astype(np.float32)
    return (spec_j.with_backend(backend, **extra_j.get(backend, {})),
            spec_t.with_backend(backend, **extra_t.get(backend, {})),
            params_j, tk.params_from_numpy(_np(params_j), "cpu"), x)


@pytest.mark.parametrize("backend,qat", [(b, True) for b in BACKENDS]
                         + [("fused", False), ("lut", False)])
def test_param_tree_gradients_match_jax(jx, backend, qat):
    """Every backend trains through the shared dispatch with finite
    gradients equal to ``jax.grad``'s; ``fused`` without QAT too (its
    forward had no autograd graph before the Function)."""
    spec_j, spec_t, params_j, params_t, x = _two_layer(jx, backend)
    g_j = jx.jax.grad(lambda p: jx.jnp.sum(jx.kan.train_apply(
        p, jx.jnp.asarray(x), spec_j, qat=qat) ** 2))(params_j)
    leaves = {(l, k): p.requires_grad_() for l, lp in params_t.items()
              for k, p in lp.items()}
    loss = torch.sum(tk.train_apply(params_t, torch.from_numpy(x), spec_t,
                                    qat=qat) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (l, k), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), (l, k)
        assert float(g.abs().max()) > 0, (l, k)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[l][k]),
                                   err_msg=f"{l}/{k}", **GRAD_TOL)


def _smoke(jx, backend):
    cfg_j = dataclasses.replace(
        jx.cf.CFKANConfig(n_items=256, hidden=16,
                          asp_enc=jx.quant.ASPConfig(grid_size=7),
                          asp_dec=jx.quant.ASPConfig(grid_size=7)),
        backend=backend)
    cfg_t = dataclasses.replace(cf_kan_1.SMOKE_MODEL, backend=backend)
    assert (cfg_t.n_items, cfg_t.hidden) == (256, 16)
    params_j = jx.cf.init(jx.jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j, tk.params_from_numpy(_np(params_j), "cpu")


@pytest.mark.parametrize("backend,qat", [("lut", True), ("fused", True),
                                         ("fused", False), ("ref", False)])
def test_multinomial_loss_matches_jax(jx, backend, qat):
    cfg_j, cfg_t, params_j, params_t = _smoke(jx, backend)
    x = cf_synth.generate(n_users=64, n_items=256, seed=2).observed
    want = jx.cf.multinomial_loss(params_j, jx.jnp.asarray(x), cfg_j, qat=qat)
    got = tcf.multinomial_loss(params_t, torch.from_numpy(x), cfg_t, qat=qat)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("backend", ["lut", "fused"])
def test_five_sgd_steps_match_jax(jx, backend):
    """The script's ``train`` against the JAX example's loop (jitted
    ``value_and_grad`` of the QAT loss, ``p - lr * g``, batches of 64 from
    ``cf_synth.batches(train, 64, seed=0)``), step for step."""
    cfg_j, cfg_t, params_j, params_t = _smoke(jx, backend)
    train_ds, _ = cf_synth.split(cf_synth.generate(n_users=1024,
                                                   n_items=256, seed=0))
    loss_grad = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, x: jx.cf.multinomial_loss(p, x, cfg_j, qat=True)))
    p, losses_j, weights_j = params_j, [], []
    for xb in list(cf_synth.batches(train_ds, 64, seed=0))[:5]:
        loss, g = loss_grad(p, jx.jnp.asarray(xb))
        p = jx.jax.tree.map(lambda a, b: a - 2e-2 * b, p, g)
        losses_j.append(float(loss))
        weights_j.append(_np(p))
    x_train = torch.from_numpy(train_ds.observed)
    asp = cfg_t.asp_dec
    enc_j = dataclasses.replace(cfg_j.kan_spec, dims=(256, 16),
                                asp=(cfg_j.asp_enc,), layer_names=())
    for k in range(1, 6):
        res = ttrain.train(params_t, cfg_t, train_ds, steps=k)
        assert len(res.losses) == k
        np.testing.assert_allclose(res.losses, losses_j[:k], rtol=1e-6)
        for l, lp in res.params.items():
            for name, w in lp.items():
                np.testing.assert_allclose(
                    w.numpy(), weights_j[k - 1][l][name], atol=1e-5,
                    err_msg=f"step {k} {l}/{name}")
        # decoder input codes of the training users, both packages
        h_t = tk.train_apply(res.params["enc"], x_train, dataclasses.replace(
            cfg_t.kan_spec, dims=(256, 16), asp=(cfg_t.asp_enc,),
            layer_names=()), qat=True)
        h_j = jx.kan.train_apply(
            jx.jax.tree.map(jx.jnp.asarray, weights_j[k - 1]["enc"]),
            jx.jnp.asarray(train_ds.observed), enc_j, qat=True)
        q_t = tq.quantize_input(tk.bound_input(h_t, asp), asp).numpy()
        q_j = np.asarray(jx.quant.quantize_input(
            jx.kan.bound_input(h_j, cfg_j.asp_dec), cfg_j.asp_dec))
        assert (q_t != q_j).mean() <= 5e-3, (k, int((q_t != q_j).sum()))
        if backend == "lut":
            assert (q_t == q_j).all(), k


def test_train_does_not_change_its_input_and_learns():
    cfg = dataclasses.replace(cf_kan_1.SMOKE_MODEL, backend="fused")
    params = tcf.init(0, cfg, device="cpu")
    before = {l: {k: p.clone() for k, p in lp.items()}
              for l, lp in params.items()}
    train_ds, val_ds = cf_synth.split(cf_synth.generate(n_users=256,
                                                        n_items=256, seed=0))
    seen = []
    res = ttrain.train(params, cfg, train_ds, steps=6,
                       on_step=lambda k, loss: seen.append((k, float(loss))))
    assert seen == list(enumerate(res.losses, start=1))
    for l, lp in params.items():
        for k, p in lp.items():
            assert torch.equal(p, before[l][k]) and not p.requires_grad
            assert not res.params[l][k].requires_grad
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    m = ttrain.evaluate(res.params, cfg, val_ds)
    assert set(m) == {"recall_float", "recall_asp", "ndcg_float", "ndcg_asp"}
    assert all(0.0 <= v <= 1.0 for v in m.values())


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["enc", "dec"])
def test_fused_function_cf_kan_1_on_card(cuda, layer):
    """The Function at CF-KAN-1's shapes and batch 64, data from the
    synthetic users: the forward launches the kernel and matches the plain
    formula in float64 at ``atol 2e-5, rtol 1e-5``; d/dcoeffs matches the
    quantised-basis product in float64 at ``atol 1e-5, rtol 1e-5``; the
    decoder's d/dx matches the float path's derivative in float64 at the
    same bar plus ``1e-6 * sum|terms|`` (its f32 sums run over 163,840
    terms in another order)."""
    cfg = cf_kan_1.MODEL
    asp = cfg.asp_enc if layer == "enc" else cfg.asp_dec
    rng = np.random.default_rng(0)
    x_users = cf_synth.generate(n_users=64, n_items=cfg.n_items,
                                seed=0).observed
    if layer == "enc":
        x = torch.from_numpy(x_users)
        shape = (cfg.n_items, asp.n_basis, cfg.hidden)
    else:
        x = torch.from_numpy(rng.normal(size=(64, cfg.hidden))
                             .astype(np.float32))
        shape = (cfg.hidden, asp.n_basis, cfg.n_items)
    xb = tk.bound_input(x, asp).to(cuda)
    coeffs = torch.from_numpy((rng.normal(size=shape) * 0.03)
                              .astype(np.float32)).to(cuda)
    dy = torch.from_numpy(rng.normal(size=(64, shape[-1]))
                          .astype(np.float32)).to(cuda)
    xg = xb.clone().requires_grad_(layer == "dec")
    cg = coeffs.clone().requires_grad_()
    tops.reset_launch_counts()
    y = tops.kan_spline_fused(xg, cg, asp)
    assert tops.launch_counts()["kan_fused"] == 1
    y.backward(dy)
    torch.cuda.synchronize()
    codes, scale = tq.quantize_coeffs(coeffs, asp, axis=(0, 1))
    e = tq.quantized_basis(xb, tq.hemi_for(asp, cuda), asp).reshape(64, -1)
    exact = (e.double() @ codes.double().reshape(e.shape[1], -1)) \
        * scale.double().reshape(-1)
    np.testing.assert_allclose(y.detach().cpu().double().numpy(),
                               exact.cpu().numpy(), **FWD_TOL)
    want_dc = (e.double().T @ dy.double()).reshape(shape)
    np.testing.assert_allclose(cg.grad.cpu().double().numpy(),
                               want_dc.cpu().numpy(), **GRAD_TOL)
    if layer == "dec":
        want_dx, mass = tref.kan_spline_dx_f64(xb, coeffs, asp, dy)
        err = (xg.grad.double() - want_dx).abs()
        assert bool((err <= 1e-5 + 1e-5 * want_dx.abs() + 1e-6 * mass).all())
    else:
        assert xg.grad is None
