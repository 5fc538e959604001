"""Port parity: the multi-tile chip simulator (repro_torch.hw.tiles,
variation, chip, cost_model, input_gen and the ``cim_tiled`` backend)
against the JAX reference, plus the ``cim_mac_tiled`` kernel against its
plain version on the card.

* The plain per-tile readout (``ref.cim_mac_tiled_codes``) adds each tile's
  rows in row order, as the CUDA kernel does. At the JAX suite's shape
  (9x96 by 96x20, As 32) its int32 codes equal JAX's oracle and its Pallas
  kernel (interpret mode) bit for bit. At larger shapes the bar is the
  whole-step rule: equal except in under 0.1% of outputs, each off by one
  ``2^k`` ADC step (JAX's own kernel differs from its oracle so).
* The mapper's permutations, the reports and the cost model equal JAX's.
* The port draws its variation gains from its own per-tile generators
  (``jax.random`` cannot be reproduced); the draws are held to their
  statistics and to determinism, and parity cases carry JAX's gains across.
* ``cuda``-marked cases launch the kernel on the card and skip without one.
  They import no JAX: ``python -m pytest -q -m cuda
  tests/test_torch_chip.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cf_kan_1 as tc1  # noqa: E402
from repro_torch.core import kan as tk, kan_sam as tsam  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.hw import chip as tchip, cim as tcim  # noqa: E402
from repro_torch.hw import cost_model as tcost, input_gen as tig  # noqa: E402
from repro_torch.hw import tiles as ttiles, variation as tvar  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.models import cf_kan as tcf  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

TILED_FIELDS = ("w_phys", "gain", "logical_of_phys", "valid",
                "phys_of_logical")
MAX_STEP_SHARE = 1e-3


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import cf_kan_1
    from repro.core import kan, kan_sam, quant
    from repro.hw import chip, cim, cost_model, input_gen, tiles, variation
    from repro.kernels import ops
    from repro.models import cf_kan
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cf_kan_1=cf_kan_1, kan=kan, kan_sam=kan_sam,
        quant=quant, chip=chip, cim=cim, cost_model=cost_model,
        input_gen=input_gen, tiles=tiles, variation=variation, ops=ops,
        cf_kan=cf_kan)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tile_pair(jx, **kw):
    return jx.tiles.TileConfig(**kw), ttiles.TileConfig(**kw)


def _chip_pair(jx, sigma=0.0, seed=0, tile=None, **kw):
    tile = tile or {}
    return (jx.chip.ChipConfig(
                tile=jx.tiles.TileConfig(**tile),
                variation=jx.variation.VariationConfig(sigma=sigma,
                                                       seed=seed), **kw),
            tchip.ChipConfig(
                tile=ttiles.TileConfig(**tile),
                variation=tvar.VariationConfig(sigma=sigma, seed=seed), **kw))


def _tiled_np(tiled):
    return {f: None if getattr(tiled, f) is None
            else np.array(getattr(tiled, f)) for f in TILED_FIELDS}


def _assert_whole_steps(got, want):
    """Equal except in under 0.1% of outputs, each off by one 2^k step."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    off = diff[diff != 0]
    assert off.size <= MAX_STEP_SHARE * diff.size, off.size
    assert all(int(d) & (int(d) - 1) == 0 and d <= 128 for d in off), off


# ---------------------------------------------------------------------------
# tiles: attenuation, images, readout codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("array_size,gamma0", [(32, 0.15), (64, 0.02),
                                               (128, 0.2), (16, 3.0)])
def test_slot_attenuation_and_images_bitwise(jx, array_size, gamma0):
    tj, tt = _tile_pair(jx, array_size=array_size, tile_cols=8,
                        gamma0=gamma0)
    n = 4 * array_size
    np.testing.assert_array_equal(
        ttiles.slot_attenuation(n, tt, "cpu").numpy(),
        np.asarray(jx.tiles.slot_attenuation(n, tj)))
    assert tt.lsb == tj.lsb and tt.gamma() == tj.gamma()
    assert dataclasses.asdict(tt.as_cim()) == dataclasses.asdict(tj.as_cim())
    assert ttiles.grid_shape(n + 1, 17, tt) == jx.tiles.grid_shape(n + 1, 17,
                                                                    tj)
    w = np.random.default_rng(array_size).integers(
        -127, 128, (n, 24)).astype(np.int8)
    img_j = np.asarray(jx.tiles.pack_image(jx.jnp.asarray(w), tj))
    img_t = ttiles.pack_image(torch.from_numpy(w), tt)
    np.testing.assert_array_equal(img_t.numpy(), img_j)
    np.testing.assert_array_equal(ttiles.unpack_image(img_t, tt).numpy(), w)


def _suite_inputs(jx):
    """test_chip.py's bitwise case: 3 row tiles of 32, ragged batch and
    columns, JAX's variation gains."""
    key = jx.jax.random.PRNGKey(3)
    tj, tt = _tile_pair(jx, array_size=32, tile_cols=16, gamma0=0.15)
    v = jx.jax.random.uniform(key, (9, 96))
    w = jx.jax.random.randint(jx.jax.random.fold_in(key, 1), (96, 20), -127,
                              128, dtype=jx.jnp.int8)
    gain = jx.variation.grid_gain(
        jx.variation.VariationConfig(sigma=0.08, seed=5), 0, 3, 2, 32, 16)
    gain = jx.tiles.unpack_image(gain, tj)[:, :20]
    return tj, tt, v, w, gain


@pytest.mark.parametrize("with_gain", [True, False])
def test_readout_and_kernel_wrapper_bitwise_at_suite_shape(jx, with_gain):
    tj, tt, v, w, gain = _suite_inputs(jx)
    if not with_gain:
        gain = None
    g_t = None if gain is None else torch.from_numpy(np.array(gain))
    v_t, w_t = torch.from_numpy(np.array(v)), torch.from_numpy(np.array(w))
    codes_j = np.asarray(jx.tiles.readout_codes(v, w, tj, gain=gain))
    codes_t = ttiles.readout_codes(v_t, w_t, tt, gain=g_t)
    assert codes_t.shape == (9, 3, 20) and codes_t.dtype == torch.int32
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    kern_j = np.asarray(jx.ops.cim_mac_tiled(
        v, w, jx.tiles.slot_attenuation(96, tj), gain=gain, array_size=32,
        adc_bits=tj.adc_bits, in_scale=tj.adc_in_scale))
    kern_t = tops.cim_mac_tiled(
        v_t, w_t, ttiles.slot_attenuation(96, tt, "cpu"), gain=g_t,
        array_size=32, adc_bits=tt.adc_bits, in_scale=tt.adc_in_scale)
    assert kern_t.dtype == torch.int32
    np.testing.assert_array_equal(kern_t.numpy(), kern_j)
    np.testing.assert_array_equal(kern_t.numpy(), codes_j.sum(axis=-2))
    # tiled_mac = codes * lsb, in both packages
    y_t = ttiles.tiled_mac(v_t, w_t, tt, gain=g_t)
    np.testing.assert_array_equal(
        y_t.numpy(), (codes_t.sum(-2, dtype=torch.int32).to(torch.float32)
                      * tt.lsb).numpy())
    np.testing.assert_allclose(
        y_t.numpy(), np.asarray(jx.tiles.tiled_mac(v, w, tj, gain=gain)),
        rtol=1e-6)


@pytest.mark.parametrize("b,r,c,array_size", [(37, 640, 72, 128),
                                              (64, 1024, 50, 256)])
def test_plain_matches_jax_by_whole_steps(jx, b, r, c, array_size):
    tj, tt = _tile_pair(jx, array_size=array_size, tile_cols=16, gamma0=0.1)
    rng = np.random.default_rng(r + c)
    v = rng.random((b, r), dtype=np.float32)
    w = rng.integers(-127, 128, (r, c)).astype(np.int8)
    tr, tc = jx.tiles.grid_shape(r, c, tj)
    gain = np.array(jx.tiles.unpack_image(jx.variation.grid_gain(
        jx.variation.VariationConfig(sigma=0.05, seed=1), 0, tr, tc,
        array_size, 16), tj))[:, :c]
    att_j = jx.tiles.slot_attenuation(r, tj)
    want_oracle = np.asarray(jx.tiles.readout_codes(
        jx.jnp.asarray(v), jx.jnp.asarray(w), tj,
        gain=jx.jnp.asarray(gain)).sum(-2))
    want_kernel = np.asarray(jx.ops.cim_mac_tiled(
        jx.jnp.asarray(v), jx.jnp.asarray(w), att_j,
        gain=jx.jnp.asarray(gain), array_size=array_size, in_scale=0.2))
    got = tref.cim_mac_tiled_ref(
        torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(gain),
        ttiles.slot_attenuation(r, tt, "cpu"), array_size, 8, 0.2).numpy()
    _assert_whole_steps(got, want_oracle)
    _assert_whole_steps(got, want_kernel)


def test_readout_noise_statistics():
    """The noise path adds sigma_psum LSBs per (tile, slice) before the ADC:
    the codes move, and the same generator seed gives the same codes."""
    tt = ttiles.TileConfig(array_size=32, tile_cols=16, sigma_psum=2.0)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random((64, 96), dtype=np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (96, 40)).astype(np.int8))
    clean = ttiles.readout_codes(v, w, tt)
    noisy = ttiles.readout_codes(v, w, tt,
                                 generator=torch.Generator().manual_seed(1))
    again = ttiles.readout_codes(v, w, tt,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(noisy, again)
    d = (noisy - clean).to(torch.float64)
    # each code moves by round(2 LSB noise) per slice, weighted by 2^k:
    # std ~ sigma * sqrt(sum_k 4^k) ~ 2 * 147.8 (rounding adds a little)
    assert 200 < float(d.std()) < 400
    assert abs(float(d.mean())) < 4 * float(d.std()) / d.numel() ** 0.5
    y = ttiles.tiled_mac(v, w, tt, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        y.numpy(), (noisy.sum(-2, dtype=torch.int32).to(torch.float32)
                    * tt.lsb).numpy())


def test_wrapper_rejects_bad_inputs():
    v = torch.rand(3, 64)
    w = torch.zeros(64, 5, dtype=torch.int8)
    att = torch.ones(64)
    with pytest.raises(ValueError, match="multiple"):
        tops.cim_mac_tiled(v, w, att, array_size=48)
    with pytest.raises(ValueError):
        tops.cim_mac_tiled(v, w.to(torch.int32), att, array_size=32)
    with pytest.raises(ValueError):
        tops.cim_mac_tiled(v, w, att[:32], array_size=32)
    with pytest.raises(ValueError):
        tops.cim_mac_tiled(v, w, att, gain=torch.ones(64, 4), array_size=32)
    with pytest.raises(ValueError):
        tops.cim_mac_tiled(v, torch.zeros(5, 64, dtype=torch.int8).t(), att,
                           array_size=32)
    # the launchers take CUDA tensors only (and check before building)
    from repro_torch.kernels import cim_mac as launchers
    with pytest.raises(ValueError, match="CUDA"):
        launchers.cim_mac_tiled(v, w, torch.ones(64, 5), att, array_size=32,
                                lsb=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        launchers.cim_mac_tiled(v, w, None, att, array_size=32, lsb=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        launchers.cim_mac(v, w, att, array_size=32, lsb=0.1)


# ---------------------------------------------------------------------------
# the mapper and the reports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_setup(jx):
    """test_chip.py's mapper case: a 16 -> 8 layer at G=8 with a third of
    its expanded rows zeroed, and JAX criticality from Phase-A stats."""
    jk, jq = jx.kan, jx.quant
    spec = jk.KANSpec.single(16, 8, jq.ASPConfig(grid_size=8))
    key = jx.jax.random.PRNGKey(0)
    params = jk.init(key, spec)
    x = jx.jnp.clip(jx.jax.random.normal(jx.jax.random.fold_in(key, 1),
                                         (32, 16)) * 0.35, -0.999, 0.999)
    asp = spec.asp[0]
    stats = jx.kan_sam.update_stats(jx.kan_sam.init_stats(16, asp),
                                    jk.bound_input(x, asp), asp)
    codes, _ = jq.quantize_coeffs(params["coeffs"], asp, axis=(0, 1))
    r = 16 * asp.n_basis
    kill = np.zeros(r, dtype=bool)
    kill[np.random.RandomState(0).choice(r, r // 3, replace=False)] = True
    codes = jx.jnp.where(jx.jnp.asarray(kill).reshape(16, -1, 1), 0, codes)
    crit = jx.kan_sam.criticality(stats, codes).reshape(-1)
    return dict(codes=np.array(codes), crit=np.array(crit),
                codes_j=codes, crit_j=crit)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("sam", [False, True])
def test_place_layer_matches_jax(jx, layer_setup, compact, sam):
    cj, ct = _chip_pair(jx, tile=dict(array_size=32, tile_cols=8),
                        compact=compact)
    got = tchip.place_layer(
        torch.from_numpy(layer_setup["codes"]),
        torch.from_numpy(layer_setup["crit"]) if sam else None, ct)
    want = _tiled_np(jx.chip.place_layer(
        layer_setup["codes_j"], layer_setup["crit_j"] if sam else None, cj))
    for f in TILED_FIELDS:
        if want[f] is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    assert got.w_phys.dtype == torch.int8
    assert tchip.layer_report(got, 8, ct) == jx.chip.layer_report(
        jx.chip.place_layer(layer_setup["codes_j"],
                            layer_setup["crit_j"] if sam else None, cj),
        8, cj)
    np.testing.assert_array_equal(
        tchip.layer_image(got, ct).numpy(),
        np.asarray(jx.tiles.pack_image(jx.jnp.asarray(want["w_phys"]),
                                       cj.tile)))


def test_place_layer_with_variation_and_inventory(layer_setup):
    codes = torch.from_numpy(layer_setup["codes"])
    ccfg = tchip.ChipConfig(
        tile=ttiles.TileConfig(array_size=32, tile_cols=8),
        variation=tvar.VariationConfig(sigma=0.05, seed=3))
    tiled = tchip.place_layer(codes, None, ccfg, layer_uid=2)
    tr, tc = ttiles.grid_shape(16 * 11, 8, ccfg.tile)
    assert tiled.gain.shape == tiled.w_phys.shape == (tr * 32, tc * 8)
    np.testing.assert_array_equal(
        ttiles.pack_image(tiled.gain, ccfg.tile).numpy(),
        tvar.grid_gain(ccfg.variation, 2, tr, tc, 32, 8).numpy())
    with pytest.raises(ValueError, match="inventory"):
        tchip.place_layer(codes, None, dataclasses.replace(ccfg, n_tiles=2))


def _jax_stack(jx):
    """A two-layer stack (12 -> 10 -> 6, G=7) with JAX params, inputs and
    Phase-A stats, and the same carried to the port."""
    jk, jq = jx.kan, jx.quant
    spec_j = jk.KANSpec(dims=(12, 10, 6), asp=(jq.ASPConfig(grid_size=7),))
    spec_t = tk.KANSpec(dims=(12, 10, 6), asp=(tq.ASPConfig(grid_size=7),))
    params_j = jk.init(jx.jax.random.PRNGKey(3), spec_j)
    params_t = tk.params_from_numpy(jx.jax.tree.map(np.asarray, params_j),
                                    "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    asp = spec_j.asp[0]
    stats_j = {}
    for name, d in (("l0", 12), ("l1", 10)):
        xs = np.clip(rng.normal(size=(256, d)) * 0.4, -0.99, 0.99
                     ).astype(np.float32)
        stats_j[name] = jx.kan_sam.update_stats(
            jx.kan_sam.init_stats(d, asp), jx.jnp.asarray(xs), asp)
    return spec_j, spec_t, params_j, params_t, x, stats_j


def _stats_to_port(stats_j):
    return {k: tsam.BasisStats(cnt=torch.tensor(np.asarray(s.cnt)),
                               s1=torch.tensor(np.asarray(s.s1)),
                               s2=torch.tensor(np.asarray(s.s2)),
                               n_samples=s.n_samples)
            for k, s in stats_j.items()}


def _layers_np(dep):
    fields = ("codes", "scale", "hemi", "w_base", "atten", "row_order",
              "slices")
    out = []
    for l in dep.layers:
        d = {f: None if getattr(l, f) is None else np.asarray(getattr(l, f))
             for f in fields}
        d["tiles"] = _tiled_np(l.tiles)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def stack(jx):
    spec_j, spec_t, params_j, params_t, x, stats_j = _jax_stack(jx)
    return dict(spec_j=spec_j, spec_t=spec_t, params_j=params_j,
                params_t=params_t, x=x, stats_j=stats_j,
                stats_t=_stats_to_port(stats_j))


CHIP_TILE = dict(array_size=32, tile_cols=4, gamma0=0.3)


@pytest.mark.parametrize("sam", [False, True])
def test_deploy_placement_and_report_match_jax(jx, stack, sam):
    cj, ct = _chip_pair(jx, sigma=0.05, seed=1, tile=CHIP_TILE)
    dep_j = jx.kan.deploy(stack["params_j"], stack["spec_j"].with_backend(
        "cim_tiled", cim=cj, use_sam=sam), stats=stack["stats_j"])
    dep_t = tk.deploy(stack["params_t"], stack["spec_t"].with_backend(
        "cim_tiled", cim=ct, use_sam=sam), stats=stack["stats_t"])
    for lj, lt in zip(_layers_np(dep_j), dep_t.layers):
        np.testing.assert_array_equal(lt.row_order.numpy(), lj["row_order"])
        for f in TILED_FIELDS:
            if f == "gain":      # drawn by each package's own generator
                assert lt.tiles.gain.shape == lj["tiles"]["gain"].shape
                continue
            np.testing.assert_array_equal(getattr(lt.tiles, f).numpy(),
                                          lj["tiles"][f], err_msg=f)
    assert tchip.chip_report(dep_t) == jx.chip.chip_report(dep_j)


@pytest.mark.parametrize("sam", [False, True])
def test_carried_artifact_serves_the_same_outputs(jx, stack, sam):
    cj, ct = _chip_pair(jx, sigma=0.05, seed=1, tile=CHIP_TILE)
    dep_j = jx.kan.deploy(stack["params_j"], stack["spec_j"].with_backend(
        "cim_tiled", cim=cj, use_sam=sam), stats=stack["stats_j"])
    spec_t = stack["spec_t"].with_backend("cim_tiled", cim=ct, use_sam=sam)
    dep_t = tk.deployed_from_numpy(_layers_np(dep_j), spec_t, "cpu")
    assert dep_t.layers[0].tiles.valid.dtype == torch.bool
    want = np.asarray(jx.kan.apply(dep_j, jx.jnp.asarray(stack["x"])))
    got = tk.apply(dep_t, torch.from_numpy(stack["x"]))
    assert got.shape == (40, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(np.abs(want).max()) > 0


def test_chip_uid_and_seed_draw_distinct_chips(stack):
    ccfg = tchip.ChipConfig(
        tile=ttiles.TileConfig(array_size=32, tile_cols=4),
        variation=tvar.VariationConfig(sigma=0.05, seed=0))
    spec = stack["spec_t"].with_backend("cim_tiled", cim=ccfg)
    d0 = tk.deploy(stack["params_t"], spec, chip_uid=0)
    d1 = tk.deploy(stack["params_t"], spec, chip_uid=1)
    again = tk.deploy(stack["params_t"], spec, chip_uid=0)
    other = tk.deploy(stack["params_t"], spec.with_backend(
        "cim_tiled", cim=ccfg.with_seed(2)))
    g = [[l.tiles.gain for l in d.layers] for d in (d0, d1, again, other)]
    assert not torch.equal(g[0][0][:32, :4], g[1][0][:32, :4])   # chip_uid
    assert not torch.equal(g[0][0][:32, :4], g[0][1][:32, :4])   # layer
    assert not torch.equal(g[0][0][:32, :4], g[3][0][:32, :4])   # seed
    assert all(torch.equal(a, b) for a, b in zip(g[0], g[2]))     # repeat
    # chip_uid 1's first layer is layer id n_layers * 1 + 0 = 2
    tr, tc = ttiles.grid_shape(12 * 10, 10, ccfg.tile)
    np.testing.assert_array_equal(
        ttiles.pack_image(g[1][0], ccfg.tile).numpy(),
        tvar.grid_gain(ccfg.variation, 2, tr, tc, 32, 4).numpy())
    for a, b in zip(d0.layers, d1.layers):
        assert torch.equal(a.tiles.logical_of_phys, b.tiles.logical_of_phys)


def test_backend_contract(stack, monkeypatch):
    spec = stack["spec_t"]
    assert "cim_tiled" in tk.backends()
    with pytest.raises(TypeError, match="ChipConfig"):
        tk.deploy(stack["params_t"], spec.with_backend(
            "cim_tiled", cim=tcim.CIMConfig()))
    with pytest.raises(ValueError, match="Phase-A"):
        tk.deploy(stack["params_t"], spec.with_backend("cim_tiled",
                                                       use_sam=True))
    dep = tk.deploy(stack["params_t"], spec.with_backend("cim_tiled"))
    assert dep.layers[0].tiles.gain is None       # default chip: ideal cells
    x = torch.from_numpy(stack["x"])
    y = tk.apply(dep, x)

    def poisoned(*a, **k):
        raise AssertionError("the serving path requantised")
    monkeypatch.setattr(tq, "quantize_coeffs", poisoned)
    monkeypatch.setattr(tq, "hemi_for", poisoned)
    assert torch.equal(tk.apply(dep, x), y)
    noisy = tk.apply(dep, x, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(noisy).all()) and not torch.equal(noisy, y)


# ---------------------------------------------------------------------------
# the chip's physics, in the port alone (test_chip.py's seams)
# ---------------------------------------------------------------------------

def _port_setup(b=32, i=16, o=8, g=8, seed=0, x_std=0.35):
    spec = tk.KANSpec.single(i, o, tq.ASPConfig(grid_size=g))
    params = tk.init(seed, spec, device="cpu")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(np.clip(rng.normal(size=(b, i)) * x_std, -0.999,
                                 0.999).astype(np.float32))
    return spec, params, x


def test_ideal_tiled_forward_matches_monolithic_cim():
    spec, params, x = _port_setup(i=24, o=20, g=7)
    tile = ttiles.TileConfig(array_size=64, tile_cols=16, gamma0=0.1)
    dep_t = tk.deploy(params, spec.with_backend(
        "cim_tiled", cim=tchip.ChipConfig(tile=tile, compact=False)))
    dep_m = tk.deploy(params, spec.with_backend("cim", cim=tile.as_cim()))
    y_t, y_m = tk.apply(dep_t, x), tk.apply(dep_m, x)
    np.testing.assert_allclose(y_t.numpy(), y_m.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(y_t.abs().max()) > 0


def test_ideal_chip_matches_lut_backend():
    spec, params, x = _port_setup()
    tile = ttiles.TileConfig(array_size=64, tile_cols=32, adc_bits=16,
                             gamma0=0.0, sigma_psum=0.0, input_bits=16)
    y = tk.apply(tk.deploy(params, spec.with_backend(
        "cim_tiled", cim=tchip.ChipConfig(tile=tile))), x)
    y_lut = tk.apply(tk.deploy(params, spec.with_backend("lut")), x)
    rel = float(torch.linalg.norm(y - y_lut) / torch.linalg.norm(y_lut))
    assert rel < 5e-3, rel


def test_degradation_grows_with_as_and_sam_recovers():
    spec, params, x = _port_setup(b=48, i=48, o=32, g=8)
    asp = spec.asp[0]
    stats = tsam.update_stats(tsam.init_stats(48, asp, "cpu"),
                              tk.bound_input(x, asp), asp)
    y_ideal = tk.apply(tk.deploy(params, spec.with_backend("lut")), x)
    denom = float(torch.linalg.norm(y_ideal))

    def err(a, sam):
        ccfg = tchip.ChipConfig(
            tile=ttiles.TileConfig(array_size=a, tile_cols=32, gamma0=0.2))
        dep = tk.deploy(params, spec.with_backend(
            "cim_tiled", cim=ccfg, use_sam=sam), stats=stats if sam else None)
        return float(torch.linalg.norm(tk.apply(dep, x) - y_ideal)) / denom

    uni = [err(a, False) for a in (128, 256, 512)]
    assert uni == sorted(uni), uni
    assert err(512, True) < uni[-1]


# ---------------------------------------------------------------------------
# variation
# ---------------------------------------------------------------------------

def test_variation_statistics():
    cfg = tvar.VariationConfig(sigma=0.05, seed=7)
    g = tvar.grid_gain(cfg, 0, 4, 4, 64, 64)
    assert g.shape == (4, 4, 64, 64) and g.dtype == torch.float32
    assert abs(float(g.mean()) - 1.0) < 0.01
    assert float(g.std()) == pytest.approx(0.05, rel=0.05)
    assert float(g.min()) >= 1 - 3 * 0.05 - 1e-6
    assert float(g.max()) <= 1 + 3 * 0.05 + 1e-6
    wide = tvar.grid_gain(tvar.VariationConfig(sigma=0.5, clip=3.0), 0, 2,
                          2, 64, 64)
    assert float(wide.min()) == 0.0               # max(1 + sigma eps, 0)
    assert float(wide.max()) <= 2.5 + 1e-6        # clip at 3 sigmas
    assert torch.equal(tvar.grid_gain(tvar.VariationConfig(), 0, 1, 1, 4, 4),
                       torch.ones(1, 1, 4, 4))     # sigma 0: ideal


def test_variation_deterministic_and_order_independent():
    cfg = tvar.VariationConfig(sigma=0.07, seed=11)
    grid = tvar.grid_gain(cfg, 2, 3, 2, 16, 8)
    for tr, tc in [(2, 1), (0, 0), (1, 1), (2, 0), (0, 1), (1, 0)]:
        assert torch.equal(tvar.tile_gain(cfg, 2, tr, tc, (16, 8)),
                           grid[tr, tc])
    assert torch.equal(tvar.grid_gain(cfg, 2, 3, 2, 16, 8), grid)
    # distinct tiles / layers / seeds draw distinct variation
    assert not torch.equal(grid[0, 0], grid[1, 0])
    assert not torch.equal(grid[0, 0], grid[0, 1])
    assert not torch.equal(tvar.tile_gain(cfg, 3, 0, 0, (16, 8)), grid[0, 0])
    assert not torch.equal(
        tvar.tile_gain(cfg.with_seed(12), 2, 0, 0, (16, 8)), grid[0, 0])


def test_drift_gain_schedule():
    shape = (32, 16)
    assert torch.equal(tvar.drift_gain(tvar.DriftConfig(), 50.0, 0, 0, 0,
                                       shape), torch.ones(shape))
    cfg = tvar.DriftConfig(rate=0.05, dispersion=0.2, seed=4)
    assert torch.equal(tvar.drift_gain(cfg, 0.0, 1, 2, 3, shape),
                       torch.ones(shape))
    ages = [0.0, 8.0, 64.0, 512.0]
    gs = [tvar.drift_gain(cfg, a, 1, 2, 3, shape) for a in ages]
    for lo, hi in zip(gs, gs[1:]):
        assert bool((hi < lo).all())              # nu > 0 at dispersion 0.2
    assert torch.equal(tvar.drift_gain(cfg, 64.0, 1, 2, 3, shape), gs[2])
    assert not torch.equal(tvar.drift_gain(cfg.with_seed(5), 64.0, 1, 2, 3,
                                           shape), gs[2])
    assert not torch.equal(tvar.drift_gain(cfg, 64.0, 1, 2, 4, shape), gs[2])
    # the salt: drift exponents are not the variation draws of the same ids
    base = torch.tensor(1.0 + 64.0 / cfg.tau)
    eps_drift = ((-torch.log(gs[2]) / torch.log(base)) / cfg.rate - 1.0
                 ) / cfg.dispersion
    eps_var = (tvar.tile_gain(tvar.VariationConfig(sigma=0.01, seed=4), 1,
                              2, 3, shape) - 1.0) / 0.01
    corr = np.corrcoef(eps_drift.numpy().ravel(), eps_var.numpy().ravel())
    assert abs(corr[0, 1]) < 0.1


def test_monte_carlo_matches_jax(jx):
    def fn(s):
        return 0.25 * s * s - s + 3.0
    want = jx.variation.monte_carlo(fn, [1, 2, 3, 4, 9])
    got = tvar.monte_carlo(fn, [1, 2, 3, 4, 9])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    one = tvar.monte_carlo(fn, [5])
    assert (one.n, one.std, one.ci95) == (1, 0.0, 0.0)

    def make(a):
        return lambda s: a / 128.0 + 0.1 * s
    assert (tvar.sweep_array_size(make, [128, 256, 512], [0, 1, 2])
            == jx.variation.sweep_array_size(make, [128, 256, 512],
                                             [0, 1, 2]))
    assert tvar.DEFAULT_SIGMA == jx.variation.DEFAULT_SIGMA


# ---------------------------------------------------------------------------
# cost model and input generator
# ---------------------------------------------------------------------------

ASP_POINTS = [dict(grid_size=g, coeff_bits=b, ld_cap=ld)
              for g in (4, 8, 16, 32, 64) for b in (8, 4) for ld in (None, 1)]


@pytest.mark.parametrize("point", ASP_POINTS)
def test_cost_model_per_point_matches_jax(jx, point):
    cj, ct = jx.quant.ASPConfig(**point), tq.ASPConfig(**point)
    jc = jx.cost_model
    for name in ("conventional_bx_area", "conventional_bx_energy",
                 "asp_bx_area", "asp_bx_energy", "powergap_structure",
                 "operating_point_bx_units"):
        assert getattr(tcost, name)(ct) == getattr(jc, name)(cj), name
    for mode in ("TD-A", "TD-P"):
        assert (dataclasses.asdict(tcost.kan_model_cost(38_928_384, ct, 16384,
                                                        mode))
                == dataclasses.asdict(jc.kan_model_cost(38_928_384, cj, 16384,
                                                        mode)))


def test_cost_model_scale_and_mixed_match_jax(jx):
    jc = jx.cost_model
    for n in (78, 1_000_000, 38_928_384, 62_881_792):
        a, b = tcost.accelerator_cost(n), jc.accelerator_cost(n)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.energy_nj == b.energy_nj
    assert tcost.accelerator_cost(38_928_384).params == 38_928_384
    assert (dataclasses.asdict(tcost.PRIOR_TINY).keys()
            == dataclasses.asdict(jc.PRIOR_TINY).keys())
    assert tcost.PRIOR_TINY.area_mm2 == jc.PRIOR_TINY.area_mm2
    layers_j = [(1_769_472, 16384, jx.quant.ASPConfig(grid_size=7)),
                (17_694_720, 108, jx.quant.ASPConfig(grid_size=7,
                                                     coeff_bits=4, ld_cap=2))]
    layers_t = [(n, c, tq.ASPConfig(grid_size=a.grid_size,
                                    coeff_bits=a.coeff_bits, ld_cap=a.ld_cap))
                for n, c, a in layers_j]
    assert (dataclasses.asdict(tcost.mixed_kan_cost(layers_t))
            == dataclasses.asdict(jc.mixed_kan_cost(layers_j)))
    budget = dict(max_area_mm2=100.0, max_power_w=0.1)
    cost = tcost.accelerator_cost(38_928_384)
    assert (tcost.HardwareBudget(**budget).satisfied_by(cost)
            == jc.HardwareBudget(**budget).satisfied_by(
                jc.accelerator_cost(38_928_384)))


def test_input_gen_matches_jax(jx):
    ji = jx.input_gen
    for n in (1, 2, 3, 4):
        for scheme in ("voltage", "pwm", "tmdv"):
            a, b = tig.input_scheme_cost(scheme, n), ji.input_scheme_cost(
                scheme, n)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.fom == b.fom
        assert ({k: dataclasses.asdict(v) for k, v in tig.scheme_table(n)
                 .items()} == {k: dataclasses.asdict(v)
                               for k, v in ji.scheme_table(n).items()})
    assert ({k: dataclasses.asdict(v) for k, v in tig.MODES.items()}
            == {k: dataclasses.asdict(v) for k, v in ji.MODES.items()})
    with pytest.raises(ValueError):
        tig.input_scheme_cost("tmdv", 5)
    with pytest.raises(ValueError):
        tig.input_scheme_cost("laser", 2)


# ---------------------------------------------------------------------------
# the slice: a narrow CF-KAN served through cim_tiled in both packages
# ---------------------------------------------------------------------------

N_ITEMS, HIDDEN = 128, 16
SLICE_TILE = dict(array_size=256, tile_cols=64, gamma0=0.08)


@pytest.fixture(scope="module")
def cf_slice(jx):
    """CF-KAN (128 items, hidden 16) from JAX params, JAX Phase-A stats and
    JAX gains, deployed ``cim_tiled`` uniform and KAN-SAM in both packages;
    the port's gains are replaced by JAX's after checking the placement."""
    jcf, jk = jx.cf_kan, jx.kan
    cfg_j = dataclasses.replace(jx.cf_kan_1.SMOKE_MODEL, n_items=N_ITEMS,
                                hidden=HIDDEN)
    cfg_t = dataclasses.replace(tc1.SMOKE_MODEL, n_items=N_ITEMS,
                                hidden=HIDDEN)
    params_j = jcf.init(jx.jax.random.PRNGKey(0), cfg_j)
    params_t = tk.params_from_numpy(jx.jax.tree.map(np.asarray, params_j),
                                    "cpu")
    from repro.data import cf_synth
    ds = cf_synth.generate(n_users=192, n_items=N_ITEMS, seed=0)
    stats_j = jcf.collect_layer_stats(
        params_j, [jx.jnp.asarray(ds.observed[:64]),
                   jx.jnp.asarray(ds.observed[64:128])], cfg_j)
    stats_t = _stats_to_port(stats_j)
    cj, ct = _chip_pair(jx, sigma=0.05, seed=0, tile=SLICE_TILE)
    x, held = ds.observed[128:], ds.held_out[128:]
    out = {}
    for variant, sam in (("uniform", False), ("sam", True)):
        dep_j = jk.deploy(params_j, cfg_j.kan_spec.with_backend(
            "cim_tiled", cim=cj, use_sam=sam), stats=stats_j)
        dep_t = tk.deploy(params_t, cfg_t.kan_spec.with_backend(
            "cim_tiled", cim=ct, use_sam=sam), stats=stats_t)
        layers = []
        for lj, lt in zip(_layers_np(dep_j), dep_t.layers):
            for f in TILED_FIELDS:
                if f != "gain":
                    np.testing.assert_array_equal(
                        getattr(lt.tiles, f).numpy(), lj["tiles"][f],
                        err_msg=f)
            layers.append(dataclasses.replace(lt, tiles=dataclasses.replace(
                lt.tiles, gain=torch.from_numpy(lj["tiles"]["gain"]))))
        dep_t = tk.DeployedKAN(tuple(layers), dep_t.spec)
        out[variant] = (np.asarray(jk.apply(dep_j, jx.jnp.asarray(x))),
                        tk.apply(dep_t, torch.from_numpy(x)))
    return dict(x=x, held=held, scores=out)


@pytest.mark.parametrize("variant", ["uniform", "sam"])
def test_cf_kan_cim_tiled_scores_and_metrics_match(jx, cf_slice, variant):
    want, got = cf_slice["scores"][variant]
    assert got.shape == (64, N_ITEMS) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    jcf, jnp = jx.cf_kan, jx.jnp
    xj, hj = jnp.asarray(cf_slice["x"]), jnp.asarray(cf_slice["held"])
    xt, ht = torch.from_numpy(cf_slice["x"]), torch.from_numpy(
        cf_slice["held"])
    top_j = np.asarray(jx.jax.lax.top_k(
        jnp.where(xj > 0, -jnp.inf, jnp.asarray(want)), 20)[1])
    np.testing.assert_array_equal(tcf._top_k(got, xt, 20).numpy(), top_j)
    r_j = float(jcf.recall_at_k(jnp.asarray(want), hj, xj))
    n_j = float(jcf.ndcg_at_k(jnp.asarray(want), hj, xj))
    assert float(tcf.recall_at_k(got, ht, xt)) == pytest.approx(
        r_j, rel=1e-6, abs=1e-7)
    assert float(tcf.ndcg_at_k(got, ht, xt)) == pytest.approx(
        n_j, rel=1e-6, abs=1e-7)
    assert r_j > 0


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------

# (B, R, C, As, with gain): the suite's shape, ragged B and C, one tile,
# ideal cells (gain None), As 1024 (four 256-row lists per tile) with B
# not a multiple of the kernel's 16-row batch group
KERNEL_CASES = [(9, 96, 20, 32, True), (37, 640, 72, 128, True),
                (5, 64, 33, 64, True), (16, 256, 40, 64, False),
                (256, 2048, 128, 256, True), (250, 4096, 128, 1024, True),
                (33, 2048, 40, 1024, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,c,array_size,with_gain", KERNEL_CASES)
def test_cim_mac_tiled_kernel_matches_plain(cuda, b, r, c, array_size,
                                            with_gain):
    rng = np.random.default_rng(b + r + c)
    tile = ttiles.TileConfig(array_size=array_size, tile_cols=16,
                             gamma0=0.15)
    v = torch.from_numpy(rng.random((b, r), dtype=np.float32)).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(np.int8)
                         ).to(cuda)
    gain = None
    if with_gain:
        tr, tc = ttiles.grid_shape(r, c, tile)
        gain = ttiles.unpack_image(tvar.grid_gain(
            tvar.VariationConfig(sigma=0.08, seed=5), 0, tr, tc, array_size,
            16), tile)[:, :c].contiguous().to(cuda)
    att = ttiles.slot_attenuation(r, tile, cuda)
    kw = dict(array_size=array_size, adc_bits=8, in_scale=tile.adc_in_scale)
    before = tops.launch_counts()["cim_mac_tiled"]
    got = tops.cim_mac_tiled(v, w, att, gain=gain, **kw)
    torch.cuda.synchronize()
    assert tops.launch_counts()["cim_mac_tiled"] == before + 1
    want = tref.cim_mac_tiled_ref(v, w, gain, att, array_size, 8,
                                  tile.adc_in_scale)
    assert got.dtype == torch.int32 and got.shape == (b, c)
    assert torch.equal(got, want)
    # row tiles split across blocks sum by atomics: still repeatable
    assert torch.equal(tops.cim_mac_tiled(v, w, att, gain=gain, **kw), got)


def _structured_wl(rng, b, n_inputs, n_slots=10, n_live=4, spread=0.1):
    """WL values shaped as a KAN layer's quantised basis: per input, n_live
    adjacent slots of n_slots are nonzero (levels k/255). Most batch rows
    share an input's slots, as CF-KAN's 0/1 encoder inputs do; a share
    ``spread`` of (b, input) pairs takes another start slot."""
    start = np.broadcast_to(rng.integers(0, n_slots - n_live + 1, n_inputs),
                            (b, n_inputs)).copy()
    moved = rng.random((b, n_inputs)) < spread
    start[moved] = rng.integers(0, n_slots - n_live + 1, int(moved.sum()))
    v = np.zeros((b, n_inputs, n_slots), dtype=np.float32)
    for j in range(n_live):
        np.put_along_axis(v, (start + j)[..., None],
                          rng.integers(1, 256, (b, n_inputs, 1)) / 255.0, -1)
    return v.reshape(b, -1)


# (inputs, B, R, C, As): structured-sparse WL values at CF-KAN's encoder
# and decoder shapes cut to size (the decoder's 108 inputs x 10 slots and
# its 200 padding rows, dead), As 1024; codes of +-127 and -128 (bit 7); a
# tile dead for every batch row with rows live for one batch row only
STRUCTURED_CASES = [("wl", 256, 2560, 128, 256),
                    ("wl_padded", 200, 1280, 300, 256),
                    ("wl", 64, 4096, 128, 1024),
                    ("extreme", 37, 1024, 72, 128),
                    ("dead_tile", 50, 1024, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs,b,r,c,array_size", STRUCTURED_CASES)
def test_cim_mac_tiled_kernel_on_structured_inputs(cuda, inputs, b, r, c,
                                                   array_size):
    rng = np.random.default_rng(b + r + c)
    tile = ttiles.TileConfig(array_size=array_size, tile_cols=64,
                             gamma0=0.08)
    w = rng.integers(-127, 128, (r, c)).astype(np.int8)
    if inputs.startswith("wl"):
        v = np.zeros((b, r), dtype=np.float32)
        n_in = (r - 200 if inputs == "wl_padded" else r) // 10
        v[:, :10 * n_in] = _structured_wl(rng, b, n_in)
    elif inputs == "extreme":
        v = rng.random((b, r), dtype=np.float32)
        v[rng.random((b, r)) < 0.6] = 0.0
        w[rng.random((r, c)) < 0.1] = -128
        w[rng.random((r, c)) < 0.1] = 127
        w[rng.random((r, c)) < 0.1] = -127
    else:
        v = rng.random((b, r), dtype=np.float32)
        v[rng.random((b, r)) < 0.7] = 0.0
        v[:, array_size:2 * array_size] = 0.0
        for i, row in enumerate((3, 2 * array_size + 5, r - 1)):
            v[:, row] = 0.0
            v[(5 * i + 1) % b, row] = 0.75
    tr, tc = ttiles.grid_shape(r, c, tile)
    gain = ttiles.unpack_image(tvar.grid_gain(
        tvar.VariationConfig(sigma=0.05, seed=0), 0, tr, tc, array_size, 64),
        tile)[:, :c].contiguous().to(cuda)
    v_t = torch.from_numpy(v).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    att = ttiles.slot_attenuation(r, tile, cuda)
    kw = dict(array_size=array_size, adc_bits=8, in_scale=tile.adc_in_scale)
    got = tops.cim_mac_tiled(v_t, w_t, att, gain=gain, **kw)
    again = tops.cim_mac_tiled(v_t, w_t, att, gain=gain, **kw)
    want = tref.cim_mac_tiled_ref(v_t, w_t, gain, att, array_size, 8,
                                  tile.adc_in_scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    if inputs == "extreme":
        assert bool((w_t == -128).any())
    if inputs == "dead_tile":
        codes = tref.cim_mac_tiled_codes(v_t, w_t, gain, att, array_size, 8,
                                         tile.adc_in_scale)
        assert not bool(codes[:, 1].any()) and bool(codes[:, 0].any())
