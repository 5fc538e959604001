"""Port parity for the mesh's collectives and the kernels and MoE under a
mesh, on 4 gloo ranks on the CPU (``test_torch_mesh_ranks.run_ranks``;
each case spawns its ranks once per module), against the JAX package
under the same mesh shape on 4 of the 8 forced host devices.

* ``psum_int8_error_feedback`` over 4 ranks against JAX's ``shard_map``
  version over 4 devices: the codes and scales bitwise, the mean within
  ``1e-6`` of JAX's (both sum the same dequantised terms; XLA's einsum
  may add them in another order) and within 0.02 relative of the exact
  mean, bitwise the same on every rank, the residual exactly what the
  rounding dropped.
* DTensor placements: ``("pod", "data")`` nests pod-major, the rows each
  rank holds are the rows JAX puts on the device at the same coordinate.
* ``kan_spline_fused`` (the KAN-FFN's up and down layers, placed by their
  ``param_spec`` names) and ``ssd`` on a 2x2 mesh: output and every
  gradient against the unsharded call within ``rtol 1e-5, atol 1e-6``
  (each rank's kernel is the unsharded math on its rows and channels; a
  gradient reduced over ranks adds its partial sums in another order).
* ``apply_moe`` on 2x2 with JAX's packed parameters: the expert-parallel
  output and aux losses (data shard 0's, as the reference returns them)
  against JAX's within ``1e-5``; its gradients against JAX's under the
  mesh and against the port's unsharded gradient of the loss JAX
  differentiates (each data shard routed alone, the aux losses averaged
  over the shards, though their value is shard 0's); the
  weights-stationary output and aux against JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_mesh_ranks import run_ranks  # noqa: E402

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.dist import compress as jcompress  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _jmesh(shape, names):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


# --- int8 error-feedback all-reduce ------------------------------------------

@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((4, 8, 512)).astype(np.float32)
    out = run_ranks("psum", 4, tmp_path_factory.mktemp("psum"),
                    {"grads": grads})
    from jax.experimental.shard_map import shard_map
    mesh = _jmesh((4,), ("data",))

    def fn(g, e):
        o, ne = jcompress.psum_int8_error_feedback(
            {"w": g[0]}, {"w": e[0].reshape(-1)}, axis="data")
        return o["w"][None], ne["w"][None]
    jout, jef = shard_map(fn, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data")), check_rep=False)(
        jnp.asarray(grads), jnp.zeros((4, 8 * 512)))
    return grads, out, np.asarray(jout), np.asarray(jef)


def test_psum_codes_bitwise(psum):
    grads, out, _, _ = psum
    for r in range(4):
        codes, scale = jcompress._quantize(jnp.asarray(grads[r]))
        np.testing.assert_array_equal(out[r]["codes"], np.asarray(codes))
        np.testing.assert_array_equal(out[r]["scale"], np.asarray(scale))


def test_psum_mean_against_jax(psum):
    grads, out, jout, _ = psum
    for r in range(4):
        np.testing.assert_allclose(out[r]["out"], jout[r], rtol=0, atol=1e-6)
    want = grads.mean(axis=0)
    rel = np.linalg.norm(out[0]["out"] - want) / np.linalg.norm(want)
    assert rel < 0.02, rel


def test_psum_ranks_bitwise_equal(psum):
    _, out, _, _ = psum
    for r in range(1, 4):
        np.testing.assert_array_equal(out[r]["out"], out[0]["out"])


def test_psum_residual_is_what_rounding_dropped(psum):
    grads, out, _, jef = psum
    for r in range(4):
        deq = (out[r]["codes"].astype(np.float32)
               * np.where(out[r]["scale"] > 0, out[r]["scale"], 1)[:, None])
        np.testing.assert_array_equal(
            out[r]["ef"], grads[r].reshape(-1) - deq.reshape(-1)[:4096])
        np.testing.assert_array_equal(out[r]["ef"], jef[r])


# --- placements --------------------------------------------------------------

def test_pod_data_nesting_matches_jax(tmp_path):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    out = run_ranks("placement", 4, tmp_path, {"x": x})
    mesh = _jmesh((2, 2, 1), ("pod", "data", "model"))
    arr = jax.device_put(jnp.asarray(x),
                         NamedSharding(mesh, P(("pod", "data"), None)))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for res in out:
        assert res["placements"] == ["S(0)", "S(0)", "R"]
        dev = mesh.devices[res["coord"]]
        np.testing.assert_array_equal(res["local"], by_dev[dev])


# --- kernels under the mesh --------------------------------------------------

@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    rng = np.random.default_rng(3)
    f32 = np.float32
    inp = {
        "kan_x": np.tanh(rng.standard_normal((4, 6, 8))).astype(f32),
        "kan_h": np.tanh(rng.standard_normal((4, 6, 6))).astype(f32),
        "kan_up": (rng.standard_normal((8, 11, 6)) * 0.3).astype(f32),
        "kan_down": (rng.standard_normal((6, 11, 8)) * 0.3).astype(f32),
        "kan_up_w": rng.standard_normal((4, 6, 6)).astype(f32),
        "kan_down_w": rng.standard_normal((4, 6, 8)).astype(f32),
        "x": rng.standard_normal((4, 16, 4, 8)).astype(f32),
        "dt": (np.abs(rng.standard_normal((4, 16, 4))) * 0.3 + 0.05
               ).astype(f32),
        "a": -np.abs(rng.standard_normal(4)).astype(f32) - 0.2,
        "b": rng.standard_normal((4, 16, 6)).astype(f32),
        "c": rng.standard_normal((4, 16, 6)).astype(f32),
        "d": rng.standard_normal(4).astype(f32),
        "ssd_w": rng.standard_normal((4, 16, 4, 8)).astype(f32),
    }
    return run_ranks("kernels", 4, tmp_path_factory.mktemp("kernels"), inp)


@pytest.mark.parametrize("which", ["up", "down"])
@pytest.mark.parametrize("what", ["y", "dx", "dc"])
def test_kan_spline_fused_sharded_equals_unsharded(kernels, which, what):
    for res in kernels:
        plain, mesh = res[which][what]
        np.testing.assert_allclose(mesh, plain, rtol=RTOL, atol=ATOL)
    # the coefficients really were split (I over data, O over model)
    assert kernels[0]["up"]["coeff_placements"] == ["S(0)", "S(2)"]
    assert kernels[0]["down"]["coeff_placements"] == ["S(2)", "S(0)"]


@pytest.mark.parametrize("i,name", list(enumerate(
    ["x", "dt", "a", "B", "C", "d_skip"])))
def test_ssd_sharded_equals_unsharded(kernels, i, name):
    for res in kernels:
        plain, mesh = res["ssd"]["y"]
        np.testing.assert_allclose(mesh, plain, rtol=RTOL, atol=ATOL)
        plain, mesh = res["ssd"]["grads"][i]
        np.testing.assert_allclose(mesh, plain, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# --- MoE under the mesh ------------------------------------------------------

MOE_CFG = dict(d_model=16, d_ff=24, n_experts=4, top_k=2,
               capacity_factor=1.0)


def _jloss(cfg, w):
    def loss(p, x):
        y, aux = jmoe.apply_moe(p, x, cfg)
        return (y * w).sum() + aux["moe_load_balance"] + aux["moe_z"]
    return loss


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    cfg = jmoe.MoEConfig(**MOE_CFG)
    params = jmoe.init_moe(jax.random.PRNGKey(1), cfg, n_model=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    w = rng.standard_normal((4, 6, 16)).astype(np.float32)
    pnp = {k: np.asarray(v) for k, v in params.items()}
    out = run_ranks("moe", 4, tmp_path_factory.mktemp("moe"),
                    {"cfg": MOE_CFG, "params": pnp, "x": x, "w": w})
    mesh = _jmesh((2, 2), ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg))(params, x)
        ys, auxs = jax.jit(lambda p, x: jmoe.apply_moe(
            p, x, cfg, weights_stationary=True))(params, x)
        grads = jax.jit(jax.grad(_jloss(cfg, w), argnums=(0, 1)))(params, x)
    ref = {"grads": {"x": np.asarray(grads[1]),
                     **{k: np.asarray(v) for k, v in grads[0].items()}},
           "ep": (np.asarray(y), {k: np.asarray(v) for k, v in aux.items()}),
           "ws": (np.asarray(ys), {k: np.asarray(v)
                                   for k, v in auxs.items()})}
    return out, ref, pnp, x, w


@pytest.mark.parametrize("path", ["ep", "ws"])
def test_sharded_moe_forward_matches_jax(moe, path):
    out, ref, _, _, _ = moe
    y, aux = ref[path]
    for res in out:
        np.testing.assert_allclose(res[path]["y"], y, rtol=1e-5, atol=1e-5)
        for k in aux:
            np.testing.assert_allclose(res[path]["aux"][k], aux[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_ep_capacity_and_aux_are_data_shard_zeros(moe):
    """The reference's expert-parallel aux losses are those of data shard
    0's tokens routed alone (capacity from one shard's tokens)."""
    from repro_torch.models import moe as tmoe
    out, _, pnp, x, _ = moe
    cfg = tmoe.MoEConfig(**MOE_CFG)
    p1 = {k: torch.from_numpy(v if k == "router" else
                              v.reshape((1, -1) + v.shape[2:]))
          for k, v in pnp.items()}
    _, aux0 = tmoe.apply_moe(p1, torch.from_numpy(x[:2]), cfg)
    for k, v in aux0.items():
        np.testing.assert_allclose(out[0]["ep"]["aux"][k], v.numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_ep_gradients_match_jax(moe):
    out, ref, _, _, _ = moe
    for res in out:
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(res["ep"]["grads"][name], g,
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_ep_gradients_match_unsharded(moe):
    from repro_torch.models import moe as tmoe
    out, _, pnp, x, w = moe
    cfg = tmoe.MoEConfig(**MOE_CFG)
    p1 = {k: torch.from_numpy(v if k == "router" else
                              v.reshape((1, -1) + v.shape[2:])
                              ).requires_grad_() for k, v in pnp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    # capacity as under the mesh: each data shard routed alone; the aux
    # gradient is that of the shards' mean
    ys, aux_sum = [], 0.0
    for s in range(2):
        y, aux = tmoe.apply_moe(p1, xt[2 * s:2 * s + 2], cfg)
        ys.append(y)
        aux_sum = aux_sum + aux["moe_load_balance"] + aux["moe_z"]
    loss = (torch.cat(ys) * torch.from_numpy(w)).sum() + aux_sum / 2
    keys = sorted(p1)
    grads = torch.autograd.grad(loss, [xt] + [p1[k] for k in keys])
    for res in out:
        for name, g in zip(["x"] + keys, grads):
            got = res["ep"]["grads"][name]
            np.testing.assert_allclose(got.reshape(g.shape), g.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
