"""Port parity: the KAN registry and two-phase deploy/apply
(repro_torch.core.kan, kan_sam, hw.cim) against the JAX reference.

* Deploying the same params (carried by ``params_from_numpy``) gives the
  same artifact bit for bit: codes, scales, SH-LUT, bit slices, and the
  KAN-SAM row order and attenuation (Phase-A stats carried across).
* ``apply`` on one artifact (carried by ``deployed_from_numpy``) matches per
  backend: ``ref``/``lut``/``fused`` at the fused kernel's bar (atol 2e-5,
  rtol 1e-5) and ``cim`` at the crossbar kernel's bar (atol 2e-3,
  rtol 1e-4): both packages add each array's rows in the same order, so
  the ADC readouts agree and only f32 accumulation order differs.
* Serving never requantises: ``apply`` runs with ``quantize_coeffs`` and
  ``hemi_for`` poisoned.
* The cim readout noise is held to its statistics (threefry draws cannot
  be reproduced).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kan as jk, kan_sam as jsam, quant as jq  # noqa: E402
from repro.hw import cim as jcim  # noqa: E402
from repro_torch.core import kan as tk, kan_sam as tsam  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.hw import cim as tcim  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

ARTIFACT_FIELDS = ("codes", "scale", "hemi", "w_base", "atten", "row_order",
                   "slices")
# backend name -> (JAX spec overrides, port spec overrides)
CIM = dict(array_size=64, gamma0=0.08)
VARIANTS = {
    "ref": ({}, {}),
    "lut": ({}, {}),
    "fused": ({}, {}),
    "cim": (dict(cim=jcim.CIMConfig(**CIM)), dict(cim=tcim.CIMConfig(**CIM))),
    "cim_sam": (dict(cim=jcim.CIMConfig(**CIM), use_sam=True),
                dict(cim=tcim.CIMConfig(**CIM), use_sam=True)),
}
TOL = {"ref": (2e-5, 1e-5), "lut": (2e-5, 1e-5), "fused": (2e-5, 1e-5),
       "cim": (2e-3, 1e-4), "cim_sam": (2e-3, 1e-4)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stats_to_port(s):
    return tsam.BasisStats(cnt=torch.tensor(np.asarray(s.cnt)),
                           s1=torch.tensor(np.asarray(s.s1)),
                           s2=torch.tensor(np.asarray(s.s2)),
                           n_samples=s.n_samples)


def _layers_np(dep):
    return [{f: (None if getattr(l, f) is None else np.asarray(getattr(l, f)))
             for f in ARTIFACT_FIELDS} for l in dep.layers]


@pytest.fixture(scope="module")
def setup():
    """A two-layer KAN stack (12 -> 10 -> 6, G=7) with JAX-initialised
    params, bounded-range inputs and Phase-A stats for both layers."""
    asp_j = jq.ASPConfig(grid_size=7)
    asp_t = tq.ASPConfig(grid_size=7)
    spec_j = jk.KANSpec(dims=(12, 10, 6), asp=(asp_j,))
    spec_t = tk.KANSpec(dims=(12, 10, 6), asp=(asp_t,))
    params_j = jk.init(jax.random.PRNGKey(3), spec_j)
    params_t = tk.params_from_numpy(_np_tree(params_j), "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    stats_x = np.clip(rng.normal(size=(256, 12)) * 0.4, -0.99, 0.99
                      ).astype(np.float32)
    stats_h = np.clip(rng.normal(size=(256, 10)) * 0.4, -0.99, 0.99
                      ).astype(np.float32)
    stats_j = {
        "l0": jsam.update_stats(jsam.init_stats(12, asp_j),
                                jnp.asarray(stats_x), asp_j),
        "l1": jsam.update_stats(jsam.init_stats(10, asp_j),
                                jnp.asarray(stats_h), asp_j)}
    stats_t = {k: _stats_to_port(v) for k, v in stats_j.items()}
    return dict(spec_j=spec_j, spec_t=spec_t, params_j=params_j,
                params_t=params_t, x=x, stats_j=stats_j, stats_t=stats_t)


def _specs(setup, variant):
    backend = "cim" if variant.startswith("cim") else variant
    kj, kt = VARIANTS[variant]
    return (setup["spec_j"].with_backend(backend, **kj),
            setup["spec_t"].with_backend(backend, **kt))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_deploy_artifact_bitwise(setup, variant):
    spec_j, spec_t = _specs(setup, variant)
    dep_j = jk.deploy(setup["params_j"], spec_j, stats=setup["stats_j"])
    dep_t = tk.deploy(setup["params_t"], spec_t, stats=setup["stats_t"])
    assert len(dep_t.layers) == 2
    for lj, lt in zip(_layers_np(dep_j), dep_t.layers):
        for f in ARTIFACT_FIELDS:
            got = getattr(lt, f)
            if lj[f] is None:
                assert got is None, f
                continue
            assert got is not None, f
            np.testing.assert_array_equal(got.numpy(), lj[f], err_msg=f)
    if variant == "cim_sam":   # the SAM mapping is a real permutation
        order = dep_t.layers[0].row_order.numpy()
        assert sorted(order.tolist()) == list(range(order.size))
        assert (order != np.arange(order.size)).any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_on_one_artifact_matches(setup, variant):
    spec_j, spec_t = _specs(setup, variant)
    dep_j = jk.deploy(setup["params_j"], spec_j, stats=setup["stats_j"])
    dep_t = tk.deployed_from_numpy(_layers_np(dep_j), spec_t, "cpu")
    want = np.asarray(jk.apply(dep_j, jnp.asarray(setup["x"])))
    got = tk.apply(dep_t, torch.from_numpy(setup["x"]))
    assert got.shape == (40, 6) and got.dtype == torch.float32
    atol, rtol = TOL[variant]
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("backend", ["ref", "lut", "fused"])
def test_train_apply_forward_matches(setup, backend):
    spec_j, spec_t = _specs(setup, backend)
    want = jk.train_apply(setup["params_j"], jnp.asarray(setup["x"]), spec_j)
    got = tk.train_apply(setup["params_t"], torch.from_numpy(setup["x"]),
                         spec_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # apply_any dispatches raw params to the training path, artifacts to apply
    np.testing.assert_array_equal(
        tk.apply_any(setup["params_t"], torch.from_numpy(setup["x"]),
                     spec_t).numpy(), got.numpy())
    # the QAT forward (fake-quantised coefficients) matches JAX's too
    want_q = jk.train_apply(setup["params_j"], jnp.asarray(setup["x"]),
                            spec_j, qat=True)
    got_q = tk.train_apply(setup["params_t"], torch.from_numpy(setup["x"]),
                           spec_t, qat=True)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=2e-5,
                               rtol=1e-5)


def test_serving_never_requantizes(setup, monkeypatch):
    """Deploy first, then poison coefficient quantisation and LUT building:
    apply must still run on every ported backend."""
    x = torch.from_numpy(setup["x"])
    deployed = {}
    for variant in VARIANTS:
        _, spec_t = _specs(setup, variant)
        deployed[variant] = tk.deploy(setup["params_t"], spec_t,
                                      stats=setup["stats_t"])

    def poisoned(*a, **k):
        raise AssertionError("the serving path requantised")
    monkeypatch.setattr(tq, "quantize_coeffs", poisoned)
    monkeypatch.setattr(tq, "hemi_for", poisoned)
    for variant, dep in deployed.items():
        y = tk.apply(dep, x)
        assert bool(torch.isfinite(y).all()), variant
        assert tk.apply_any(dep, x, dep.spec).shape == y.shape
    with pytest.raises(AssertionError, match="requantised"):
        tk.deploy(setup["params_t"], _specs(setup, "lut")[1])


def test_registry_and_idempotent_deploy(setup):
    assert {"ref", "lut", "fused", "cim"} <= set(tk.backends())
    with pytest.raises(KeyError, match="registered backends"):
        tk.get_backend("nope")

    @tk.register_backend("test_double_lut")
    class Doubled(tk.LutBackend):
        def run(self, layer, lspec, spec, x, generator=None):
            return 2 * super().run(layer, lspec, spec, x, generator)
    try:
        spec = setup["spec_t"].with_backend("test_double_lut",
                                            base_activation="")
        dep = tk.deploy(setup["params_t"], spec)
        assert tk.deploy(dep, spec) is dep
        x = torch.from_numpy(setup["x"])
        ref = tk.apply(tk.deploy(setup["params_t"], spec.with_backend("lut")),
                       x)
        assert dep.layers[0].slices is None
        assert tk.apply(dep, x).shape == ref.shape
    finally:
        tk._BACKENDS.pop("test_double_lut")
    with pytest.raises(ValueError, match="Phase-A"):
        tk.deploy(setup["params_t"], _specs(setup, "cim_sam")[1])


def test_param_count_matches():
    for dims, g in (((12, 10, 6), 7), ((300, 40), 15)):
        sj = jk.KANSpec(dims=dims, asp=(jq.ASPConfig(grid_size=g),))
        st = tk.KANSpec(dims=dims, asp=(tq.ASPConfig(grid_size=g),))
        assert tk.param_count(st) == jk.param_count(sj)


def test_init_is_seeded_and_shaped():
    spec = tk.KANSpec(dims=(12, 10, 6), asp=(tq.ASPConfig(grid_size=7),))
    a = tk.init(0, spec, device="cpu")
    b = tk.init(0, spec, device="cpu")
    c = tk.init(1, spec, device="cpu")
    assert set(a) == {"l0", "l1"}
    assert tuple(a["l0"]["coeffs"].shape) == (12, 10, 10)
    assert tuple(a["l1"]["w_base"].shape) == (10, 6)
    assert torch.equal(a["l0"]["coeffs"], b["l0"]["coeffs"])
    assert not torch.equal(a["l0"]["coeffs"], c["l0"]["coeffs"])
    flat = tk.init(0, tk.KANSpec.single(5, 3), device="cpu")
    assert set(flat) == {"coeffs", "w_base"}


def test_cim_noise_statistics():
    """Readout noise: mean ~ 0 and std equal to the reference's formula
    ``sigma_psum * lsb * sqrt(n_arrays * sum_k 4^k / 8)``."""
    cfg = tcim.CIMConfig(array_size=64, sigma_psum=0.3)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random((128, 200), dtype=np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (200, 96)).astype(np.int8))
    clean = tcim.cim_forward(v, w, cfg)
    noisy = tcim.cim_forward(v, w, cfg,
                             generator=torch.Generator().manual_seed(0))
    noise = (noisy - clean).numpy().ravel()
    n_arrays = -(-200 // 64)
    lsb = 64 * cfg.adc_in_scale / 255
    want = cfg.sigma_psum * lsb * np.sqrt(
        n_arrays * sum(4.0 ** k for k in range(8)) / 8.0)
    assert noise.size == 128 * 96
    assert abs(noise.mean()) < 4 * want / np.sqrt(noise.size)
    assert noise.std() == pytest.approx(want, rel=0.03)
    again = tcim.cim_forward(v, w, cfg,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(again, noisy)


def test_mac_error_rate_matches():
    rng = np.random.default_rng(1)
    v = rng.random((16, 300), dtype=np.float32)
    w = rng.integers(-127, 128, (300, 24)).astype(np.int8)
    cj = jcim.CIMConfig(array_size=128, gamma0=0.3)
    ct = tcim.CIMConfig(array_size=128, gamma0=0.3)
    want = jcim.mac_error_rate(jnp.asarray(v), jnp.asarray(w), cj)
    got = tcim.mac_error_rate(torch.from_numpy(v), torch.from_numpy(w), ct)
    assert got == pytest.approx(want, rel=1e-4)
    assert got > 0.01
