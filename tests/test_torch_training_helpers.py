"""Port parity for the float helpers of the training half of §4: the JAX
suites' own cases, run against the port on the same numpy inputs.

* ``splines.bspline_basis`` (Cox–de Boor), ``spline_eval_reference`` and
  ``lstsq_fit_coeffs`` (``test_splines.py:18,55``).
* ``quant.build_full_lut``/``build_sh_lut`` bit for bit,
  ``conventional_quantized_basis``, ``dequantize_input`` and
  ``fake_quantize_input``; ``grid_extension`` (``test_quant.py:47,166,180``).
* ``kan_sam.collect_stats`` and ``sam_attenuation``; ``sensitivity``
  (``test_kan_sam.py:21,68,81,97,108``): ``assign_grids``' classes equal to
  JAX's.
* ``hw.neurosim`` (``test_hw.py:108,120``): its decisions and history equal
  to JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import grid_extension as jge, kan as jk  # noqa: E402
from repro.core import kan_sam as jsam, quant as jq  # noqa: E402
from repro.core import sensitivity as jsens, splines as jsp  # noqa: E402
from repro.hw import cim as jcim, cost_model as jcost  # noqa: E402
from repro.hw import neurosim as jns  # noqa: E402
from repro_torch.core import grid_extension as tge, kan as tk  # noqa: E402
from repro_torch.core import kan_sam as tsam, quant as tq  # noqa: E402
from repro_torch.core import sensitivity as tsens, splines as tsp  # noqa: E402
from repro_torch.hw import cim as tcim, cost_model as tcost  # noqa: E402
from repro_torch.hw import neurosim as tns  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a))


# --- splines -----------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("grid", [3, 5, 8])
def test_cardinal_matches_coxdeboor(order, grid):
    knots = tsp.make_knots(-1.0, 1.0, grid, order)
    x = np.linspace(-0.999, 0.999, 101, dtype=np.float32)
    ref = tsp.bspline_basis(_t(x), knots, order)
    fast = tsp.bspline_basis_uniform(_t(x), -1.0, 1.0, grid, order)
    np.testing.assert_allclose(ref.numpy(), fast.numpy(), atol=1e-5)
    want = jsp.bspline_basis(jnp.asarray(x), knots, order)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-6)


def test_lstsq_fit_recovers_spline():
    grid, order = 6, 3
    coeffs = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (grid + order,)))
    x = np.linspace(-0.98, 0.98, 400, dtype=np.float32)
    y = tsp.spline_eval_reference(_t(x), _t(coeffs), -1, 1, grid, order)
    y_j = jsp.spline_eval_reference(jnp.asarray(x), jnp.asarray(coeffs), -1,
                                    1, grid, order)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-6)
    fit = tsp.lstsq_fit_coeffs(_t(x), y[:, None], -1, 1, grid, order)
    assert tuple(fit.shape) == (grid + order, 1)
    y2 = tsp.spline_eval_reference(_t(x), fit[:, 0], -1, 1, grid, order)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), atol=1e-4)
    # two f32 solves of the normal equations (see the grid-extension case)
    fit_j = jsp.lstsq_fit_coeffs(jnp.asarray(x), y_j[:, None], -1, 1, grid,
                                 order)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fit_j), atol=1e-3)


# --- quant -------------------------------------------------------------------

@pytest.mark.parametrize("g", [5, 8, 64])
def test_sh_lut_hemi_reflection(g):
    cfg = tq.ASPConfig(grid_size=g)
    full = tq.build_full_lut(cfg, "cpu")
    hemi = tq.build_sh_lut(cfg, "cpu")
    assert hemi.shape[0] == (cfg.levels_per_interval + 1) // 2
    loc = torch.arange(cfg.levels_per_interval, dtype=torch.int32)
    rec = tq.sh_lut_lookup(hemi, loc, cfg)
    assert torch.equal(rec, full)
    cfg_j = jq.ASPConfig(grid_size=g)
    np.testing.assert_array_equal(full.numpy(),
                                  np.asarray(jq.build_full_lut(cfg_j)))
    np.testing.assert_array_equal(hemi.numpy(),
                                  np.asarray(jq.build_sh_lut(cfg_j)))
    np.testing.assert_array_equal(hemi.numpy(), tq.hemi_for(cfg, "cpu"))


def test_input_dequantisation_and_fake_quant():
    cfg, cfg_j = tq.ASPConfig(grid_size=7), jq.ASPConfig(grid_size=7)
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 500).astype(np.float32)
    q = tq.quantize_input(_t(x), cfg)
    np.testing.assert_array_equal(
        tq.dequantize_input(q, cfg).numpy(),
        np.asarray(jq.dequantize_input(jnp.asarray(q.numpy()), cfg_j)))
    xt = _t(x).requires_grad_()
    fq = tq.fake_quantize_input(xt, cfg)
    np.testing.assert_array_equal(
        fq.detach().numpy(),
        np.asarray(jq.fake_quantize_input(jnp.asarray(x), cfg_j)))
    fq.sum().backward()                 # straight through
    assert torch.equal(xt.grad, torch.ones_like(xt))


def test_grid_extension_preserves_function():
    old, new = tq.ASPConfig(grid_size=5), tq.ASPConfig(grid_size=10)
    c = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, old.n_basis, 3)))
    c2 = tge.extend_coeffs(_t(c), old, new)
    assert tuple(c2.shape) == (4, new.n_basis, 3)
    x = torch.linspace(-0.95, 0.95, 100)
    for j in range(4):
        y1 = tsp.bspline_basis_uniform(x, -1, 1, 5, 3) @ _t(c[j])
        y2 = tsp.bspline_basis_uniform(x, -1, 1, 10, 3) @ c2[j]
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-3)
    # both packages solve the refit in f32; its normal matrix has condition
    # number ~1.4e3, so each solve may be off by ~1.4e3 * 2^-23 relative
    # (~1e-4 on these coefficients): the port's is held to the float64
    # solve at that, and to JAX's at twice the sum of both, 1e-3
    x64 = torch.linspace(-1 + 1e-4, 1 - 1e-4, 2048, dtype=torch.float64)
    a_old = tsp.bspline_basis_uniform(x64, -1, 1, 5, 3)
    a_new = tsp.bspline_basis_uniform(x64, -1, 1, 10, 3)
    m64 = torch.linalg.solve(a_new.T @ a_new + 1e-8 * torch.eye(
        13, dtype=torch.float64), a_new.T @ a_old)
    np.testing.assert_allclose(
        c2.numpy(), torch.einsum("ts,iso->ito", m64, _t(c).double()).numpy(),
        atol=1e-4)
    want = jge.extend_coeffs(jnp.asarray(c), jq.ASPConfig(grid_size=5),
                             jq.ASPConfig(grid_size=10))
    np.testing.assert_allclose(c2.numpy(), np.asarray(want), atol=1e-3)
    lp = tge.extend_layer_params({"coeffs": _t(c), "w_base": _t(c[0])}, old,
                                 new)
    assert torch.equal(lp["coeffs"], c2) and torch.equal(lp["w_base"],
                                                         _t(c[0]))
    with pytest.raises(ValueError, match="changes G only"):
        tge.extend_coeffs(_t(c), old, dataclasses.replace(new, order=2))


def test_conventional_vs_asp_same_accuracy_class():
    cfg = tq.ASPConfig(grid_size=8)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (4096,),
                                      minval=-1, maxval=1))
    fb = tsp.bspline_basis_uniform(_t(x), -1, 1, 8, 3)
    asp_err = (tq.quantized_basis(_t(x), tq.hemi_for(cfg, "cpu"), cfg)
               - fb).abs().mean()
    conv = tq.conventional_quantized_basis(_t(x), cfg)
    conv_err = (conv - fb).abs().mean()
    assert float(asp_err) < float(conv_err) * 1.5
    want = jq.conventional_quantized_basis(jnp.asarray(x),
                                           jq.ASPConfig(grid_size=8))
    np.testing.assert_allclose(conv.numpy(), np.asarray(want), atol=1e-6)


# --- kan_sam -----------------------------------------------------------------

def _stats_and_codes(seed, i=16, o=8, b=512, g=7, x_std=0.3):
    """``test_kan_sam.py``'s set-up in JAX, carried across."""
    key = jax.random.PRNGKey(seed)
    asp = jq.ASPConfig(grid_size=g)
    x = jnp.clip(jax.random.normal(key, (b, i)) * x_std, -0.999, 0.999)
    stats = jsam.update_stats(jsam.init_stats(i, asp), x, asp)
    coeffs = jax.random.normal(jax.random.fold_in(key, 1),
                               (i, asp.n_basis, o))
    codes, _ = jq.quantize_coeffs(coeffs, asp, axis=(0, 1))
    return asp, np.asarray(x), stats, np.asarray(codes)


def test_phase_a_statistics():
    asp = tq.ASPConfig(grid_size=7)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (256, 4),
                                      minval=-1, maxval=1))
    stats = tsam.collect_stats([_t(x[:100]), _t(x[100:])], asp, 4,
                               device="cpu")
    assert float(stats.cnt.sum()) == pytest.approx(256 * 4 * (asp.order + 1))
    assert stats.n_samples == 256
    assert bool((stats.p <= 1.0).all()) and bool((stats.var >= 0).all())
    want = jsam.collect_stats([jnp.asarray(x[:100]), jnp.asarray(x[100:])],
                              jq.ASPConfig(grid_size=7), 4)
    np.testing.assert_array_equal(stats.cnt.numpy(), np.asarray(want.cnt))
    for f in ("s1", "s2"):
        np.testing.assert_allclose(getattr(stats, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6)


def test_sam_reduces_weighted_attenuation():
    """From JAX's criticality (the port's differs in the last bits, see
    test_torch_kan.py), the port's KAN-SAM attenuation equals JAX's and
    never raises the criticality-weighted IR-drop exposure."""
    asp, x, stats, codes = _stats_and_codes(5)
    cw = np.asarray(jsam.criticality(stats, jnp.asarray(codes)))
    pos_att = tcim.row_attenuation(cw.size, tcim.CIMConfig(array_size=512),
                                   "cpu")
    att_sam = tsam.sam_attenuation(_t(cw), pos_att)
    assert tuple(att_sam.shape) == cw.shape
    want = jsam.sam_attenuation(
        jnp.asarray(cw), jcim.row_attenuation(cw.size,
                                              jcim.CIMConfig(array_size=512)))
    np.testing.assert_array_equal(att_sam.numpy(), np.asarray(want))
    exposure_sam = float((_t(cw) * (1 - att_sam)).sum())
    exposure_id = float((_t(cw).reshape(-1) * (1 - pos_att)).sum())
    assert exposure_sam <= exposure_id + 1e-6


def test_sam_improves_mac_error():
    asp, x, stats, codes = _stats_and_codes(6, b=256)
    asp_t = tq.ASPConfig(grid_size=7)
    basis = tq.quantized_basis(_t(x), tq.hemi_for(asp_t, "cpu"),
                               asp_t).reshape(x.shape[0], -1)
    w = _t(codes).reshape(-1, codes.shape[-1])
    ccfg = tcim.CIMConfig(array_size=512)
    cw = _t(np.asarray(jsam.criticality(stats, jnp.asarray(codes))))
    att = tsam.sam_attenuation(
        cw, tcim.row_attenuation(w.shape[0], ccfg, "cpu")).reshape(-1)
    e_uniform = tcim.mac_error_rate(basis, w, ccfg)
    e_sam = tcim.mac_error_rate(basis, w, ccfg, atten_of_logical=att)
    assert e_sam < e_uniform


# --- sensitivity (Algorithm 2) -----------------------------------------------

@pytest.mark.parametrize("values", [
    [10.0, 5.0, 2.0, 1.0, 0.5, 0.1],
    list(np.random.default_rng(0).lognormal(size=11)),
    [1.0, 1.0, 2.0, 2.0, 3.0]])
def test_sensitivity_grid_assignment_tiers(values):
    sens = {f"l{i}": float(v) for i, v in enumerate(values)}
    ga = tsens.assign_grids(sens, g_high=16, g_med=8, g_low=4)
    want = jsens.assign_grids(sens, g_high=16, g_med=8, g_low=4)
    assert ga.classes == want.classes and ga.grids == want.grids
    assert ga.sensitivities == want.sensitivities
    counts = {c: list(ga.classes.values()).count(c)
              for c in ("HIGH", "MEDIUM", "LOW")}
    assert counts["HIGH"] >= 1 and counts["LOW"] >= 1


def test_sensitivity_profiling_runs():
    """Phase 1 on a toy two-layer KAN stack, both packages from JAX's
    params and batches; then Phase 2 on those sensitivities."""
    key = jax.random.PRNGKey(0)
    asp_j = jq.ASPConfig(grid_size=5)
    s1j = jk.KANSpec.single(8, 8, asp_j, backend="ref")
    s2j = jk.KANSpec.single(8, 4, asp_j, backend="ref")
    params_j = {"a": jk.init(key, s1j),
                "b": jk.init(jax.random.fold_in(key, 1), s2j)}
    asp_t = tq.ASPConfig(grid_size=5)
    s1t = tk.KANSpec.single(8, 8, asp_t, backend="ref")
    s2t = tk.KANSpec.single(8, 4, asp_t, backend="ref")
    params_t = tk.params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    batches = [(np.asarray(jax.random.normal(jax.random.PRNGKey(i), (16, 8))),
                np.asarray(jax.random.normal(jax.random.PRNGKey(i + 9),
                                             (16, 4)))) for i in range(3)]

    def loss_j(p, x, y):
        h = jk.train_apply(p["a"], x, s1j)
        return jnp.mean((jk.train_apply(p["b"], h, s2j) - y) ** 2)

    def loss_t(p, x, y):
        h = tk.train_apply(p["a"], x, s1t)
        return torch.mean((tk.train_apply(p["b"], h, s2t) - y) ** 2)

    paths = ["a/coeffs", "b/coeffs"]
    sens = tsens.layer_sensitivities(
        loss_t, params_t, [(_t(x), _t(y)) for x, y in batches], paths)
    want = jsens.layer_sensitivities(
        loss_j, params_j, [(jnp.asarray(x), jnp.asarray(y))
                           for x, y in batches], paths)
    assert set(sens) == set(paths) and all(v > 0 for v in sens.values())
    for p in paths:
        assert sens[p] == pytest.approx(want[p], rel=1e-5)
    assert not params_t["a"]["coeffs"].requires_grad   # params untouched
    kw = dict(g_high=16, g_med=8, g_low=4)
    assert (tsens.assign_grids(sens, **kw).classes
            == jsens.assign_grids(want, **kw).classes)


# --- KAN-NeuroSim ------------------------------------------------------------

def test_neurosim_budget_screening():
    def count(a):
        return 30_000_000 + a.grid_size * 100_000
    out = tns.screen_constraints(
        tq.ASPConfig(grid_size=32), tcost.HardwareBudget(max_area_mm2=100.0),
        count_params=count, n_channels=1024)
    want = jns.screen_constraints(
        jq.ASPConfig(grid_size=32), jcost.HardwareBudget(max_area_mm2=100.0),
        count_params=count, n_channels=1024)
    assert out is not None and out.grid_size <= 32
    assert out.grid_size == want.grid_size
    assert tns.screen_constraints(
        tq.ASPConfig(grid_size=32), tcost.HardwareBudget(max_area_mm2=0.001),
        count_params=lambda a: 10 ** 7, n_channels=1) is None


def _history(res):
    return [(h.epoch, h.grid_size, h.val_loss, h.action,
             dataclasses.astuple(h.cost)) for h in res.history]


@pytest.mark.parametrize("area", [200.0, 1000.0])
def test_neurosim_grid_extension_reverts_on_budget(area):
    """Stage 2 with the JAX suite's callbacks in both packages: the same
    decisions, grids and costs, step by step."""
    results = {}
    for name, pkg, cost, asp in (
            ("port", tns, tcost, tq.ASPConfig(grid_size=4)),
            ("jax", jns, jcost, jq.ASPConfig(grid_size=4))):
        losses = iter([1.0, 0.9, 0.8, 0.7, 0.6, 0.5])
        calls = {"train": 0}

        def train_epochs(params, a, n):
            calls["train"] += 1
            return params

        res = pkg.grid_extension_training(
            params={}, asp=asp, train_epochs=train_epochs,
            val_loss=lambda params, a: next(losses),
            extend_coeffs=lambda p, a, b: p,
            count_params=lambda a: int(20_000_000 * (1 + a.grid_size / 8)),
            budget=cost.HardwareBudget(max_area_mm2=area), extend_every=1,
            extend_by=4, max_epochs=5)
        assert res.asp.grid_size >= 4 and calls["train"] == 5
        for h in res.history:
            if h.action == "extended":
                assert h.cost.area_mm2 <= area
        results[name] = res
    actions = [h.action for h in results["port"].history]
    assert "extended" in actions or "extension-rejected-budget" in actions
    assert _history(results["port"]) == _history(results["jax"])
    assert results["port"].asp.grid_size == results["jax"].asp.grid_size
    assert results["port"].feasible == results["jax"].feasible
