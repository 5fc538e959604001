"""Port parity for the logical-axis rules (``repro_torch.dist.sharding``),
every ``*_spec`` tree and the int8 compression (``dist.compress``),
against the JAX package, on the CPU with no process group.

* ``spec_for`` gives JAX's PartitionSpec entries, entry for entry, on fake
  meshes {data 16, model 16}, {pod 2, data 16, model 16} and 2x2 over a
  grid of shapes and logical names, the ``kv_heads`` -> ``head_dim``
  fallback and ``override_rules`` included.
* ``placements_for`` gives one ``Shard``/``Replicate`` per mesh dim, an
  entry of two axes sharding one tensor dim on both mesh dims.
* ``param_spec``, ``cache_spec``, ``paged_cache_spec`` and ``moe_spec``
  equal JAX's trees for every arch ``get_arch`` knows, at SMOKE and at
  the full config, and every leaf has one name per dim of the port's
  leaf (shapes from the meta device).
* ``_quantize``, ``_dequantize`` and ``compress_leaf`` are bitwise JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import compress as tcompress  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import compress as jcompress  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
}

SHAPES = [(1,), (2, 4), (16, 128), (8, 10, 128), (32, 16, 64, 128),
          (4, 6, 10, 12), (256, 4096)]
NAMES = [None, "batch", "seq", "seq_sp", "embed", "vocab", "heads",
         "kv_heads", "head_dim", "mlp", "state", "experts", "layers", "none"]


def _name_grid():
    rng = np.random.default_rng(0)
    cases = []
    for shape in SHAPES:
        for _ in range(12):
            cases.append((shape, tuple(NAMES[i] for i in rng.integers(
                0, len(NAMES), len(shape)))))
    return cases


def _jax_entries(p):
    return tuple(p)


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("shape,names", _name_grid())
def test_spec_for_matches_jax(mesh_id, shape, names):
    mesh = MESHES[mesh_id]
    assert tsh.spec_for(shape, names, mesh) == _jax_entries(
        jsh.spec_for(shape, names, mesh))


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_spec_for_kv_fallback_and_overrides(mesh_id):
    mesh = MESHES[mesh_id]
    kv = ((8, 128, 10, 128), ("batch", "seq", "kv_heads", "head_dim"))
    cases = [kv, ((8, 64), ("batch", "embed")), ((4096, 256), ("vocab",
                                                               "embed"))]
    for shape, names in cases:
        assert tsh.spec_for(shape, names, mesh) == _jax_entries(
            jsh.spec_for(shape, names, mesh))
    for over in ({"embed": ()}, {"batch": "model"},
                 {"heads": ("data", "model")}, {"mlp": (("data", "model"),)}):
        with tsh.override_rules(**over), jsh.override_rules(**over):
            for shape, names in cases + [((32, 64, 128), ("batch", "heads",
                                                          "mlp"))]:
                assert tsh.spec_for(shape, names, mesh) == _jax_entries(
                    jsh.spec_for(shape, names, mesh))
    # the override is gone on exit
    assert tsh.spec_for((8, 64), ("batch", "embed"), mesh) == _jax_entries(
        jsh.spec_for((8, 64), ("batch", "embed"), mesh))


def test_spec_for_refuses_extra_names():
    with pytest.raises(ValueError):
        tsh.spec_for((4,), ("batch", "seq"), MESHES["2x2"])


def test_placements_for_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    spec = tsh.spec_for((32, 16, 64), ("batch", "seq", "mlp"), mesh)
    assert spec == (("pod", "data"), None, "model")
    assert tsh.placements_for(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements_for((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsh.placements_for((("data", "pod"),), mesh)
    # no mesh: every dim replicates and shard() is the identity
    x = torch.ones(4, 4)
    assert tsh.spec_for((4, 4), ("batch", "embed")) == (None, None)
    assert tsh.shard(x, "batch", "embed") is x


ALL_ARCHS = sorted(set(jconfigs.ARCH_IDS) | set(jconfigs.AUX_ARCH_IDS))


def test_port_knows_every_arch():
    assert ALL_ARCHS == sorted(set(tconfigs.ARCH_IDS)
                               | set(tconfigs.AUX_ARCH_IDS))


def _leaves_with_names(tree, spec):
    return tsh._flatten_up_to(tree, spec)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch_id", ALL_ARCHS)
def test_spec_trees_match_jax(arch_id, smoke):
    tm = tconfigs.get_arch(arch_id, smoke=smoke).model
    jm = jconfigs.get_arch(arch_id, smoke=smoke).model
    assert ttfm.param_spec(tm) == jtfm.param_spec(jm)
    assert tdec.cache_spec(tm) == jdec.cache_spec(jm)
    assert tdec.paged_cache_spec(tm) == jdec.paged_cache_spec(jm)
    if tm.n_experts:
        assert tmoe.moe_spec(tm.moe_cfg) == jmoe.moe_spec(jm.moe_cfg)
    # every leaf is named dim for dim (shapes only: the meta device)
    params = ttfm.init_model(0, tm, device="meta")
    for leaf, names in _leaves_with_names(params, ttfm.param_spec(tm)):
        assert len(names) == leaf.dim(), (names, leaf.shape)
        assert all(n is None or n in tsh.RULES for n in names)
    # the placements resolve on a 2x2 mesh with no axis used twice
    for leaf, names in _leaves_with_names(params, ttfm.param_spec(tm)):
        spec = tsh.spec_for(leaf.shape, names, MESHES["2x2"])
        used = [a for e in spec if e
                for a in ((e,) if isinstance(e, str) else e)]
        assert len(used) == len(set(used))


@pytest.mark.parametrize("arch_id", ["mixtral_8x7b", "kimi_k2_1t_a32b"])
def test_packed_moe_params_match_spec(arch_id):
    """``init_model(n_model)`` packs the experts device-major as the
    reference does: the same shapes as JAX's at 2 and 4 model shards."""
    tm = tconfigs.get_arch(arch_id, smoke=True).model
    jm = jconfigs.get_arch(arch_id, smoke=True).model
    for n_model in (2, 4):
        tp = ttfm.init_model(0, tm, device="meta", n_model=n_model)
        jp = jax.eval_shape(lambda k: jtfm.init_model(k, jm, n_model=n_model),
                            jax.random.PRNGKey(0))
        tshapes = [tuple(t.shape) for t in ttfm.tree_leaves(tp)]
        jshapes = [tuple(a.shape) for a in jax.tree.leaves(
            jp, is_leaf=lambda x: hasattr(x, "shape"))]
        assert sorted(tshapes) == sorted(jshapes)


# --- compression ---------------------------------------------------------------

def _grad_cases():
    rng = np.random.default_rng(1)
    out = [("normal", (rng.standard_normal(5000) * 3).astype(np.float32)),
           ("ragged", rng.standard_normal((7, 333)).astype(np.float32)),
           ("zeros", np.zeros(2048, np.float32)),
           ("tiny", np.full(1024, 1e-4, np.float32)),
           ("halves", (np.arange(4096) % 255 - 127).astype(np.float32)
            * np.float32(0.5)),
           ("bf16", rng.standard_normal((64, 40)).astype(np.float32))]
    return out


@pytest.mark.parametrize("name,g", _grad_cases(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_compress_bitwise_jax(name, g):
    rng = np.random.default_rng(2)
    ef = (rng.standard_normal(g.size) * 1e-3).astype(np.float32)
    if name == "bf16":
        tg = torch.from_numpy(g).to(torch.bfloat16)
        jg = jnp.asarray(g).astype(jnp.bfloat16)
    else:
        tg, jg = torch.from_numpy(g), jnp.asarray(g)
    tc, ts = tcompress._quantize(tg)
    jc, js = jcompress._quantize(jg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcompress._dequantize(tc, ts, g.size).numpy(),
        np.asarray(jcompress._dequantize(jc, js, g.size)))
    t_out = tcompress.compress_leaf(tg, torch.from_numpy(ef))
    j_out = jcompress.compress_leaf(jg, jnp.asarray(ef))
    assert t_out[3] == j_out[3] == g.size
    for a, b in zip(t_out[:3], j_out[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_error_feedback_carries_what_rounding_dropped():
    g = torch.full((tcompress._CHUNK,), 1e-4)
    codes, scale, new_ef, n = tcompress.compress_leaf(
        g, torch.zeros(tcompress._CHUNK))
    deq = tcompress._dequantize(codes, scale, n)
    assert torch.equal(new_ef, g - deq)
    x = torch.randn(5000, generator=torch.Generator().manual_seed(0)) * 3
    c, s = tcompress._quantize(x)
    back = tcompress._dequantize(c, s, x.numel())
    assert float((back - x).abs().max()) <= float(s.max()) * 0.5 + 1e-6
