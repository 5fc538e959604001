"""Port parity for the Mixture-of-Experts FFN (``repro_torch.models.moe``)
and the MoE models (mixtral-8x7b, kimi-k2) against the JAX package.

* ``_dispatch`` gives the reference's buffer, combine indices, validity
  and drop fraction exactly (combine weights and aux losses to f32
  rounding), at capacity factors 4.0 (no drops) and 1.25, with router
  logits that tie exactly (the lower expert first, as ``jax.lax.top_k``),
  and ``tests/test_properties.py``'s dispatch invariants hold.
* ``apply_moe`` with and without a shared expert, and the combine, which
  adds each token's rows in expert order: bitwise against a sequential
  reference, and the reference's sum to f32 rounding.
* mixtral and kimi SMOKE at f32 with the reference's params: ``forward``
  logits and aux loss, prefill and decode logits within ``2e-4`` (the
  serving suite's bar), and the engine's completions equal to the
  reference engine's. At the full configs' capacity factor 1.25 each
  layer's ``moe_drop_frac`` equals the reference's on the same inputs.
* ``count_params`` of the full configs on the meta device: 46,571,720,704
  for mixtral, and kimi's from ``jax.eval_shape``.

``cuda``-marked: the dispatch and ``apply_moe`` on the card against the
CPU.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

F32_BAR = 2e-4
MIXTRAL_PARAMS = 46_571_720_704
ARCHS = ("mixtral_8x7b", "kimi_k2_1t_a32b")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import moe, transformer
    from repro.serve import decode, engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 moe=moe, tfm=transformer, dec=decode,
                                 eng=engine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfgs(jx, e=4, k=2, cf=1.25, shared=0, d=16, f=8):
    kw = dict(d_model=d, d_ff=f, n_experts=e, top_k=k, capacity_factor=cf,
              n_shared_experts=shared)
    return jx.moe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _router(rng, d, e, kind):
    """Router weights: random, two equal columns (exact ties between two
    experts), all zero (every expert ties), or one hot expert (drops:
    with ``_hot_tokens``, every token's first choice)."""
    w = rng.standard_normal((d, e)).astype(np.float32)
    if kind == "tied_pair":
        w[:, 2] = w[:, 1]
    elif kind == "all_tied":
        w[:] = 0.0
    elif kind == "hot":
        w[0, :] = 0.0
        w[0, 0] = 5.0
    return w


def _hot_tokens(toks, kind):
    if kind == "hot":
        toks[:, 0] = 3.0
    return toks


def _dispatch_both(jx, toks, rw, jc, tc, cap):
    want = jx.moe._dispatch(jx.jnp.asarray(toks), jx.jnp.asarray(rw), jc, cap)
    got = tmoe._dispatch(torch.from_numpy(toks), torch.from_numpy(rw), tc,
                         cap)
    return want, got


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("kind", ["random", "tied_pair", "all_tied", "hot"])
@pytest.mark.parametrize("t,e,k", [(37, 4, 2), (24, 8, 2), (19, 8, 8)])
def test_dispatch_equals_the_reference(jx, cf, kind, t, e, k):
    jc, tc = _cfgs(jx, e=e, k=k, cf=cf)
    rng = np.random.default_rng(t + e + k)
    toks = rng.standard_normal((t, 16)).astype(np.float32)
    if kind == "all_tied":
        toks[::3] = 0.0
    toks = _hot_tokens(toks, kind)
    rw = _router(rng, 16, e, kind)
    cap = tmoe.capacity_for(t, tc)
    assert cap == max(1, int(t * k * cf / e))
    want, got = _dispatch_both(jx, toks, rw, jc, tc, cap)
    for name, a, b in zip(("buf", "combine_tok", "valid"),
                          (want[0], want[1], want[3]),
                          (got[0], got[1], got[3])):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-7)
    assert float(got[4]["moe_drop_frac"]) == float(want[4]["moe_drop_frac"])
    for key in ("moe_load_balance", "moe_z"):
        assert float(got[4][key]) == pytest.approx(float(want[4][key]),
                                                   rel=1e-6, abs=1e-9)
    if kind in ("hot", "all_tied") and cf == 1.25 and k < e:
        assert float(got[4]["moe_drop_frac"]) > 0


def test_top_k_keeps_the_lower_index_on_ties(jx):
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = tmoe.top_k(probs, 2)
    wv, wi = jx.jax.lax.top_k(jx.jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(wi).tolist() == [[0, 1], [1, 2],
                                                        [0, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(wv))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_dispatch_invariants(seed, cf):
    """``tests/test_properties.py``'s invariants: combine weights are
    nonnegative and sum to at most 1 per token, the drop fraction lies in
    [0, 1], dispatched rows hold their tokens; at capacity T*k (no drops)
    every token's weights sum to 1."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(8, 41))
    cfg = tmoe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                         capacity_factor=cf)
    tokens = torch.from_numpy(rng.standard_normal((t, 16)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    buf, ctok, cw, valid, aux, dst = tmoe._dispatch(
        tokens, router, cfg, tmoe.capacity_for(t, cfg))
    assert bool((cw >= 0).all())
    per_tok = torch.zeros(t + 1).index_add_(0, ctok.reshape(-1),
                                            cw.reshape(-1))
    assert float(per_tok[:t].max()) <= 1.0 + 1e-5
    assert 0.0 <= float(aux["moe_drop_frac"]) <= 1.0
    assert torch.equal(buf[valid], tokens[ctok[valid]])
    assert bool((cw[~valid] == 0).all())
    # each kept slot's position holds its token; the dropped ones point past
    # the buffer, one per slot not held
    kept = dst < ctok.numel()
    tok_of = torch.arange(t)[:, None].expand_as(dst)
    assert torch.equal(ctok.reshape(-1)[dst[kept]], tok_of[kept])
    assert int(kept.sum()) == int(valid.sum())
    _, ctok, cw, _, aux, _ = tmoe._dispatch(tokens, router, cfg, t * 2)
    assert float(aux["moe_drop_frac"]) == 0.0
    sums = torch.zeros(t + 1).index_add_(0, ctok.reshape(-1), cw.reshape(-1))
    np.testing.assert_allclose(sums[:t].numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("k", [2, 8])
def test_combine_adds_in_expert_order(k):
    """Each token's weighted rows are added from zero in expert order,
    bitwise equal to a sequential loop over the buffer; run twice, the
    same bits."""
    rng = np.random.default_rng(k)
    e, t, d = 8, 30, 12
    cfg = tmoe.MoEConfig(d_model=d, d_ff=4, n_experts=e, top_k=k,
                         capacity_factor=1.25)
    tokens = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((d, e)).astype(np.float32))
    cap = tmoe.capacity_for(t, cfg)
    _, ctok, cw, _, _, dst = tmoe._dispatch(tokens, router, cfg, cap)
    out = torch.from_numpy(rng.standard_normal((e, cap, d)).astype(
        np.float32))
    y = tmoe._combine(out, cw, dst)
    want = np.zeros((t + 1, d), np.float32)
    rows = (out * cw[..., None]).numpy().reshape(-1, d)
    for pos, tok in enumerate(ctok.reshape(-1).tolist()):
        want[tok] = want[tok] + rows[pos]
    assert np.array_equal(y.numpy(), want[:t])
    assert torch.equal(tmoe._combine(out, cw, dst), y)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_apply_moe_equals_the_reference(jx, shared, cf):
    jc, tc = _cfgs(jx, e=8, k=2, cf=cf, shared=shared, d=24, f=16)
    params = jx.moe.init_moe(jx.jax.random.PRNGKey(3), jc)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, params),
                                device="cpu")
    x = np.random.default_rng(5).standard_normal((3, 7, 24)).astype(
        np.float32)
    wy, waux = jx.moe.apply_moe(params, jx.jnp.asarray(x), jc)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tc)
    sy, _ = tmoe.apply_moe(tp, torch.from_numpy(x), tc,
                           weights_stationary=True)
    assert torch.equal(ty, sy)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), atol=2e-6,
                               rtol=1e-5)
    assert float(taux["moe_drop_frac"]) == float(waux["moe_drop_frac"])
    for key in ("moe_load_balance", "moe_z"):
        assert float(taux[key]) == pytest.approx(float(waux[key]), rel=1e-6)


def test_init_moe_layout_and_packed_weights(jx):
    """The reference's tree and dtypes (the router f32 even at bf16
    params); weights packed for more model shards have the reference's
    device-major shapes, and need a mesh with that model axis to run."""
    for dt, jdt in ((torch.float32, jx.jnp.float32),
                    (torch.bfloat16, jx.jnp.bfloat16)):
        jc = jx.moe.MoEConfig(d_model=8, d_ff=6, n_experts=4, top_k=2,
                              n_shared_experts=1, dtype=jdt)
        tc = tmoe.MoEConfig(d_model=8, d_ff=6, n_experts=4, top_k=2,
                            n_shared_experts=1, dtype=dt)
        want = jx.jax.eval_shape(lambda: jx.moe.init_moe(
            jx.jax.random.PRNGKey(0), jc))
        got = tmoe.init_moe(torch.Generator().manual_seed(0), tc,
                            device="cpu")
        flat_w = jx.jax.tree_util.tree_flatten_with_path(want)[0]
        for path, leaf in flat_w:
            keys = [p.key for p in path]
            t = got
            for kk in keys:
                t = t[kk]
            assert tuple(t.shape) == leaf.shape, keys
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), keys
    tc = tmoe.MoEConfig(d_model=8, d_ff=6, n_experts=4, top_k=2)
    jc = jx.moe.MoEConfig(d_model=8, d_ff=6, n_experts=4, top_k=2)
    for n_model in (2, 8):     # experts split; d_ff split when E < n_model
        packed = tmoe.init_moe(torch.Generator().manual_seed(0), tc,
                               device="cpu", n_model=n_model)
        want = jx.jax.eval_shape(lambda: jx.moe.init_moe(
            jx.jax.random.PRNGKey(0), jc, n_model=n_model))
        assert {k: tuple(v.shape) for k, v in packed.items()} == {
            k: v.shape for k, v in want.items()}
    with pytest.raises(ValueError, match="need a mesh"):
        tmoe.apply_moe(packed, torch.zeros((1, 2, 8)), tc)


def _carried(jx, name, cf=None):
    jm = jx.get_arch(name, smoke=True).model
    tm = tconfigs.get_arch(name, smoke=True).model
    if cf is not None:
        jm = dataclasses.replace(jm, capacity_factor=cf)
        tm = dataclasses.replace(tm, capacity_factor=cf)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(0), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


@pytest.mark.parametrize("name", ARCHS)
def test_forward_equals_the_reference(jx, name):
    jm, tm, jp, tp = _carried(jx, name)
    toks = np.random.default_rng(1).integers(0, jm.vocab, (2, 24))
    jl, ja = jx.tfm.forward(jp, jm, {"tokens": jx.jnp.asarray(toks)})
    tl, ta = ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_BAR,
                               rtol=0)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    assert float(ta) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_equal_the_reference(jx, name):
    """Prefill's logits and cache, then three decode steps, at the SMOKE
    config's capacity factor, against the reference's at f32; and with no
    slot dropped, decode against forward."""
    jm, tm, jp, tp = _carried(jx, name)
    prompt = np.random.default_rng(2).integers(0, jm.vocab, (2, 20))
    max_len = 24
    jl, jc = jx.dec.prefill(jp, jm, {"tokens": jx.jnp.asarray(prompt)},
                            max_len)
    tl, tc = tdec.prefill(tp, tm, {"tokens": torch.from_numpy(prompt)},
                          max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_BAR,
                               rtol=0)
    for a, b in zip(jx.jax.tree.leaves(jc), ttfm.tree_leaves(tc)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=F32_BAR)
    tok = np.argmax(np.asarray(jl)[:, -1:], -1)
    for i in range(3):
        jl, jc = jx.dec.decode_step(jp, jc, jx.jnp.asarray(tok), 20 + i, jm)
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(tok), 20 + i, tm)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=F32_BAR, rtol=0)
        tok = np.argmax(np.asarray(jl), -1)
    # where nothing is dropped (E / top_k slots per expert) decode is
    # forward's function
    nd = dataclasses.replace(tm, capacity_factor=tm.n_experts / tm.top_k)
    full = np.concatenate([prompt, np.zeros((2, 1), np.int64)], 1)
    lf, _ = ttfm.forward(tp, nd, {"tokens": torch.from_numpy(full)})
    l20, _ = tdec.decode_step(tp, tdec.prefill(
        tp, nd, {"tokens": torch.from_numpy(prompt)}, max_len)[1],
        torch.zeros((2, 1), dtype=torch.long), 20, nd)
    np.testing.assert_allclose(l20[:, 0].numpy(), lf[:, 20].numpy(),
                               atol=F32_BAR)


@pytest.mark.parametrize("name", ARCHS)
def test_drop_fraction_at_capacity_1p25_equals_the_reference(jx, name):
    """At the full configs' capacity factor 1.25 the same layer inputs
    drop the same slots: each layer's ``moe_drop_frac`` equals the
    reference's ``apply_moe`` on the input the port's layer received, and
    the layer outputs agree to f32 rounding."""
    jm, tm, jp, tp = _carried(jx, name, cf=1.25)
    seen = []
    fn = tmoe.apply_moe

    def spy(params, x, cfg, **kw):
        y, aux = fn(params, x, cfg, **kw)
        seen.append((params, x.clone(), y, aux))
        return y, aux
    toks = np.random.default_rng(4).integers(0, jm.vocab, (3, 16))
    tmoe.apply_moe = spy
    try:
        ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    finally:
        tmoe.apply_moe = fn
    assert len(seen) == sum(sp.ffn == "moe" for sp in tm.layer_specs())
    drops = []
    for params, x, y, aux in seen:
        jpar = jx.jax.tree.map(lambda a: jx.jnp.asarray(a.numpy()), params)
        wy, waux = jx.moe.apply_moe(jpar, jx.jnp.asarray(x.numpy()),
                                    jm.moe_cfg)
        assert float(aux["moe_drop_frac"]) == float(waux["moe_drop_frac"])
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5)
        drops.append(float(aux["moe_drop_frac"]))
    assert max(drops) > 0      # 1.25 drops on these token counts


@pytest.mark.parametrize("name", ARCHS)
def test_engine_equals_the_reference_engine(jx, name):
    """The paged engine serves MoE (whole-prompt prefill, never prefix
    sharing) with the reference engine's completions, request by
    request."""
    jm, tm, jp, tp = _carried(jx, name)
    trace = dict(max_prompt=20, min_prompt=5, max_new=6, min_new=2,
                 stagger=1, common_prefix=8, seed=1)
    kw = dict(n_slots=3, max_len=36, page_size=8)
    want = jx.eng.Engine(jp, jm, **kw).run(
        jx.eng.synth_trace(jm.vocab, 6, **trace))
    eng = teng.Engine(tp, tm, device="cpu", **kw)
    assert eng.chunk_tokens is None and not eng.share_ok
    got = eng.run(teng.synth_trace(tm.vocab, 6, **trace))
    assert ({c.rid: [int(t) for t in c.tokens] for c in got}
            == {c.rid: [int(t) for t in c.tokens] for c in want})


def test_count_params_of_the_full_configs(jx):
    """Full width on the meta device: mixtral's published count, kimi's
    equal to the reference's shapes."""
    mix = tconfigs.get_arch("mixtral_8x7b").model
    assert ttfm.count_params(ttfm.init_model(0, mix, device="meta")) \
        == MIXTRAL_PARAMS
    kimi_t = tconfigs.get_arch("kimi_k2_1t_a32b").model
    kimi_j = jx.get_arch("kimi_k2_1t_a32b").model
    shapes = jx.jax.eval_shape(lambda: jx.tfm.init_model(
        jx.jax.random.PRNGKey(0), kimi_j))
    want = sum(int(np.prod(a.shape)) for a in jx.jax.tree.leaves(shapes))
    got = ttfm.count_params(ttfm.init_model(0, kimi_t, device="meta"))
    assert got == want and got > 10 ** 12


def test_configs_match_the_reference(jx):
    for name in ARCHS:
        for smoke in (False, True):
            t = tconfigs.get_arch(name, smoke=smoke).model
            j = jx.get_arch(name, smoke=smoke).model
            assert t.moe_cfg.n_experts == j.moe_cfg.n_experts
            td = dataclasses.asdict(t.moe_cfg)
            jd = dataclasses.asdict(j.moe_cfg)
            assert {k: v for k, v in td.items() if k != "dtype"} == {
                k: v for k, v in jd.items() if k != "dtype"}
            assert [dataclasses.astuple(s) for s in t.layer_specs()] == [
                dataclasses.astuple(s) for s in j.layer_specs()]
        assert name in tconfigs.ARCH_IDS


# --- cuda --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "tied_pair", "hot"])
def test_dispatch_on_the_card_equals_the_cpu(cuda, kind):
    """mixtral's routing shape (8 experts, top-2) at capacity 1.25 over 4096
    tokens: the same buffer, indices and drops on the card as on the CPU,
    the combine weights to f32 rounding, and ``apply_moe``'s output twice
    the same on the card."""
    rng = np.random.default_rng(7)
    t, d = 4096, 64
    cfg = tmoe.MoEConfig(d_model=d, d_ff=32, n_experts=8, top_k=2,
                         capacity_factor=1.25)
    toks = torch.from_numpy(_hot_tokens(
        rng.standard_normal((t, d)).astype(np.float32), kind))
    rw = torch.from_numpy(_router(rng, d, 8, kind))
    cap = tmoe.capacity_for(t, cfg)
    want = tmoe._dispatch(toks, rw, cfg, cap)
    got = tmoe._dispatch(toks.to(cuda), rw.to(cuda), cfg, cap)
    for i in (0, 1, 3, 5):
        assert torch.equal(got[i].cpu(), want[i])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=1e-7)
    assert float(got[4]["moe_drop_frac"]) == float(want[4]["moe_drop_frac"])
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    x = toks.reshape(8, t // 8, d)
    y_cpu, _ = tmoe.apply_moe(params, x, cfg)
    pc = ttfm.tree_map(lambda a: a.to(cuda), params)
    y1, _ = tmoe.apply_moe(pc, x.to(cuda), cfg)
    y2, _ = tmoe.apply_moe(pc, x.to(cuda), cfg)
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
