"""Port parity for the LM slice: mamba2-1.3b's layers, model, configs,
data and static-batch serving against the JAX package.

JAX-initialised parameters are carried across with
``transformer.params_from_numpy``; tokens are made with numpy from a seed.
Everything runs at SMOKE size (3 layers, d_model 64, N 16, P 16, chunk 16);
full width is checked only through shapes (``jax.eval_shape`` and the
port's meta-device init), never allocated.

Bars:
* f32: ``2e-4`` on logits and cache leaves, the bar of the JAX serving
  suite (``tests/test_serve.py``); greedy tokens identical.
* bf16 compute (f32 parameters): the residual stream, the scan output and
  the logits are rounded to bf16 in both packages, and an f32 difference in
  the last bits (sums in another order) can move one rounding by a bf16
  step (2^-8 relative), which later layers carry on. Leaves are held to
  ``BF16_REL`` (four bf16 steps) of their largest magnitude, and greedy
  tokens must agree up to the first step where JAX's top-1 logit leads its
  top-2 by less than that bar.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.data import lm_synth as jsyn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import mamba2_1p3b as tm2  # noqa: E402
from repro_torch.data import lm_synth as tsyn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

F32_BAR = 2e-4
BF16_REL = 2 ** -6
MAMBA2_PARAMS = 1_343_532_032
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 24


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if (
        hasattr(a, "dtype") and a.dtype == jnp.bfloat16) else np.asarray(a)


def _tn(t):
    return t.detach().float().cpu().numpy()


def _hold(got, want, dtype_name, what=""):
    want = _np(want)
    got = _tn(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = (F32_BAR if dtype_name == "f32"
           else BF16_REL * float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float32) - want.astype(np.float32)
                       ).max())
    assert err <= bar, (what, err, bar)


def _walk(jtree, ttree, path=()):
    """(path, jax leaf, port leaf) over two trees of one layout."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), (path, set(jtree), set(ttree))
        for k in jtree:
            yield from _walk(jtree[k], ttree[k], path + (k,))
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _walk(a, b, path + (i,))
    else:
        yield path, jtree, ttree


def _model(dtype_name="f32", seed=0):
    jdt, tdt = DTYPES[dtype_name]
    jm = dataclasses.replace(jget("mamba2_1p3b", smoke=True).model,
                             dtype=jdt)
    tm = dataclasses.replace(tm2.SMOKE.model, dtype=tdt)
    jp = jtfm.init_model(jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed,index", [
    (512, 2, 24, 0, 0), (50280, 4, 64, 0, 0), (1000, 3, 17, 5, 9)])
def test_lm_synth_batch_at_bit_for_bit(vocab, batch, seq, seed, index):
    jcfg = jsyn.LMDataConfig(vocab=vocab, batch=batch, seq_len=seq,
                             seed=seed)
    tcfg = tsyn.LMDataConfig(vocab=vocab, batch=batch, seq_len=seq,
                             seed=seed)
    want, got = jsyn.batch_at(jcfg, index), tsyn.batch_at(tcfg, index)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    s = tsyn.stream(tcfg, start_index=index)
    np.testing.assert_array_equal(next(s)["tokens"], want["tokens"])


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_norms_match_jax(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 48)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    jx_, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx_)
    assert got.dtype == tdt
    bar = 1e-6 if dtype_name == "f32" else 2 ** -7   # one bf16 step
    np.testing.assert_allclose(_tn(got), _np(want), rtol=bar, atol=bar)
    got = tlayers.layernorm({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)}, tx)
    want = jlayers.layernorm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jx_)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=bar, atol=bar * 4)
    assert set(tlayers.NORM_INIT) == set(jlayers.NORM_INIT)
    for kind in tlayers.NORM_INIT:
        p = tlayers.NORM_INIT[kind](7, "cpu")
        q = jlayers.NORM_INIT[kind](7)
        assert set(p) == set(q)
        for k in p:
            np.testing.assert_array_equal(_tn(p[k]), np.asarray(q[k]))


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "relu2"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 301).astype(np.float32)
    got = tlayers.ACTIVATIONS[name](torch.from_numpy(x))
    want = jlayers.ACTIVATIONS[name](jnp.asarray(x))
    np.testing.assert_allclose(_tn(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("pos_ndim", [1, 2])
def test_rope_and_positions_match_jax(pos_ndim):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 100
    if pos_ndim == 2:
        pos = np.stack([pos, pos * 3])
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             500.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    np.testing.assert_allclose(_tn(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        _tn(tlayers.rope_frequencies(32, 1e4)),
        np.asarray(jlayers.rope_frequencies(32, 1e4)), rtol=1e-6)
    np.testing.assert_allclose(
        _tn(tlayers.sinusoidal_positions(30, 24)),
        np.asarray(jlayers.sinusoidal_positions(30, 24)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_embedding_and_mixed_products_follow_jax(dtype_name):
    """embed_lookup, unembed and the promoted product: bf16 @ f32 runs in
    and returns f32 in both packages; bf16 @ bf16 stays bf16."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(2)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    ids = rng.integers(0, 40, (2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    emb = tlayers.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(_tn(emb), np.asarray(
        jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids))))
    tx, jx_ = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    got = tlayers.unembed(tx, torch.from_numpy(table).to(tdt))
    want = jlayers.unembed(jx_, jnp.asarray(table).astype(jdt))
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    bar = 1e-5 if dtype_name == "f32" else BF16_REL * 4
    np.testing.assert_allclose(_tn(got), _np(want), atol=bar, rtol=bar)
    mixed = tlayers.matmul(tx, torch.from_numpy(table.T.copy()))
    jmixed = jx_ @ jnp.asarray(table.T)
    assert mixed.dtype == torch.float32 and jmixed.dtype == jnp.float32
    np.testing.assert_allclose(_tn(mixed), np.asarray(jmixed), atol=1e-5,
                               rtol=1e-5)


def test_initialisers_draw_from_the_generator():
    """Same generator state, same draws; the JAX layout and scales."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (tlayers.dense_init(g, 64, (4, 8), device="cpu"),
                tlayers.init_embedding(g, 100, 32, dtype=torch.bfloat16,
                                       device="cpu"))
    (w1, e1), (w2, e2), (w3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(w1, w2) and torch.equal(e1, e2)
    assert not torch.equal(w1, w3)
    assert w1.shape == (64, 4, 8) and e1.dtype == torch.bfloat16
    assert abs(float(w1.std()) - 1 / 8) < 0.02
    assert abs(float(e1.float().std()) - 32 ** -0.5) < 0.02


# --- configs -----------------------------------------------------------------

def _same_config(tcfg, jcfg):
    tmap = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for f in dataclasses.fields(jcfg):
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "model":
            _same_config(tv, jv)
        elif f.name in ("dtype", "param_dtype", "grad_dtype"):
            assert tmap[tv] == jnp.dtype(jv).name, f.name
        elif f.name in ("block_pattern", "first_layers"):
            assert [dataclasses.asdict(s) for s in tv] == [
                dataclasses.asdict(s) for s in jv], f.name
        else:
            assert tv == jv, (f.name, tv, jv)
    assert {f.name for f in dataclasses.fields(tcfg)} == {
        f.name for f in dataclasses.fields(jcfg)}


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba2_config_equals_jax(smoke):
    _same_config(tconfigs.get_arch("mamba2_1p3b", smoke=smoke),
                 jget("mamba2_1p3b", smoke=smoke))
    m = tm2.CONFIG.model
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.d_ff,
            m.vocab) == (48, 2048, 1, 1, 0, 50280)
    assert (m.ssd_cfg.n_heads, m.ssd_cfg.d_inner) == (64, 4096)
    assert tconfigs.get_arch("mamba2-1.3b").name == "mamba2-1.3b"


def test_registry_and_shapes_match_jax():
    from repro import configs as jconfigs
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.AUX_ARCH_IDS == jconfigs.AUX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert tm2.CONFIG.shapes() == jget("mamba2_1p3b").shapes()
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt5")
    for name in tconfigs.ARCH_IDS + tconfigs.AUX_ARCH_IDS:
        assert tconfigs.get_arch(name).name == jget(name).name
        assert tconfigs.get_arch(name, smoke=True).name == \
            jget(name, smoke=True).name


def test_layers_pack_for_model_shards_and_unknown_parts_raise():
    """Parameters packed for several model shards (the mesh's model axis)
    are the same draws as for one when no layer has experts; cross
    attention (on any mixer) and the encoder-decoder family are ported; a
    layer part no package knows is a ValueError."""
    for spec in (ttfm.LayerSpec("attn", "mlp", cross_attn=True),
                 ttfm.LayerSpec("ssd", "mlp", cross_attn=True)):
        cfg = dataclasses.replace(
            tconfigs.get_arch("mistral_nemo_12b", smoke=True).model,
            block_pattern=(spec,))
        four = ttfm.init_model(0, cfg, device="cpu", n_model=4)
        one = ttfm.init_model(0, cfg, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            ttfm.tree_leaves(four), ttfm.tree_leaves(one)))
        assert "cross" in ttfm.init_model(0, cfg, device="cpu"
                                          )["stages"][0]["l0"]
    cfg = tconfigs.get_arch("whisper_base", smoke=True).model
    params = ttfm.init_model(0, cfg, device="cpu")
    logits, _ = ttfm.forward(params, cfg, {
        "tokens": torch.zeros((1, 4), dtype=torch.long),
        "frames": torch.zeros((1, 6, cfg.d_model))})
    assert logits.shape == (1, 4, cfg.vocab)
    bad = dataclasses.replace(tm2.SMOKE.model,
                              block_pattern=(ttfm.LayerSpec("conv", "mlp"),))
    with pytest.raises(ValueError, match="unknown mixer"):
        ttfm.init_model(0, bad, device="cpu")


@pytest.mark.parametrize("pattern_len,specs", [
    (1, "s" * 5), (3, "rrlrrlrr"), (2, "abababc"), (1, "")])
def test_stage_grouping_equals_jax(pattern_len, specs):
    def conv(mod, s):
        return [mod.LayerSpec(mixer=c, ffn="none") for c in s]
    got = ttfm.compute_stages(conv(ttfm, specs), pattern_len)
    want = jtfm.compute_stages(conv(jtfm, specs), pattern_len)
    assert [(tuple(dataclasses.asdict(b) for b in s.block), s.repeats)
            for s in got] == [(tuple(dataclasses.asdict(b) for b in s.block),
                               s.repeats) for s in want]


def test_full_width_parameter_count_without_allocating():
    """1,343,532,032 parameters, leaf for leaf the JAX layout's shapes:
    ``jax.eval_shape`` on one side, a meta-device init on the other."""
    jm = jget("mamba2_1p3b").model
    jshapes = jax.eval_shape(lambda k: jtfm.init_model(k, jm),
                             jax.random.PRNGKey(0))
    tp = ttfm.init_model(0, tm2.CONFIG.model, device="meta")
    n = 0
    for path, jl, tl in _walk(jshapes, tp):
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert str(tl.dtype).split(".")[-1] == jnp.dtype(jl.dtype).name
        assert tl.device.type == "meta"
        n += math.prod(jl.shape)
    assert n == ttfm.count_params(tp) == MAMBA2_PARAMS


# --- the model and serving ---------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_params_carry_across_leaf_by_leaf(dtype_name):
    jm, tm, jp, tp = _model(dtype_name)
    for path, jl, tl in _walk(jp, tp):
        np.testing.assert_array_equal(_tn(tl), _np(jl))
    assert ttfm.count_params(tp) == jtfm.count_params(jp)
    own = ttfm.init_model(0, tm, device="cpu")
    assert [p for p, _, _ in _walk(jp, own)]        # same layout
    assert ttfm.count_params(own) == jtfm.count_params(jp)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_forward_matches_jax(dtype_name):
    jm, tm, jp, tp = _model(dtype_name)
    toks = _tokens(jm.vocab, (B, S))
    want, jaux = jtfm.forward(jp, jm, {"tokens": jnp.asarray(toks)})
    got, aux = ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == DTYPES[dtype_name][1]
    _hold(got, want, dtype_name, "logits")
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype_name):
    """Logits and every cache leaf after prefill and after each of six
    decode steps (the conv buffer is bf16 at bf16 compute in both)."""
    jm, tm, jp, tp = _model(dtype_name, seed=1)
    toks = _tokens(jm.vocab, (B, S), seed=1)
    s0 = S - 6
    jl, jc = jdec.prefill(jp, jm, {"tokens": jnp.asarray(toks[:, :s0])},
                          max_len=S)
    tl, tc = tdec.prefill(tp, tm, {"tokens": torch.from_numpy(toks[:, :s0])},
                          max_len=S)
    _hold(tl, jl, dtype_name, "prefill logits")
    for path, a, b in _walk(jc, tc):
        assert str(b.dtype).split(".")[-1] == jnp.dtype(a.dtype).name, path
        _hold(b, a, dtype_name, path)
    for i in range(s0, S):
        jl, jc = jdec.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), i,
                                  jm)
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                  i, tm)
        _hold(tl, jl, dtype_name, ("decode logits", i))
        for path, a, b in _walk(jc, tc):
            _hold(b, a, dtype_name, (i, path))


def _first_step_without_lead(jp, jm, prompt, toks, bar):
    """The first generated step where JAX's top-1 logit leads its top-2 by
    no more than ``bar`` (teacher-forced on JAX's own tokens)."""
    logits, cache = jdec.prefill(jp, jm, {"tokens": prompt},
                                 prompt.shape[1] + toks.shape[1])
    steps = [logits[:, -1]]
    for i in range(toks.shape[1] - 1):
        logits, cache = jdec.decode_step(jp, cache, toks[:, i:i + 1],
                                         prompt.shape[1] + i, jm)
        steps.append(logits[:, 0])
    for i, lg in enumerate(steps):
        top2 = np.sort(_np(lg), axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] <= bar):
            return i
    return len(steps)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_generate_matches_jax(dtype_name):
    jm, tm, jp, tp = _model(dtype_name, seed=2)
    prompt = _tokens(jm.vocab, (B, 8), seed=2)
    want = np.asarray(jdec.generate(jp, jm, jnp.asarray(prompt), n_new=8))
    got = tdec.generate(tp, tm, torch.from_numpy(prompt), n_new=8).numpy()
    assert got.shape == want.shape == (B, 8)
    if dtype_name == "f32":
        np.testing.assert_array_equal(got, want)
        return
    lead_until = _first_step_without_lead(
        jp, jm, jnp.asarray(prompt), jnp.asarray(want), BF16_REL * 8)
    np.testing.assert_array_equal(got[:, :lead_until], want[:, :lead_until])


# --- port-only copies of the JAX serving suite's mamba2 cases ---------------

def test_prefill_decode_matches_forward():
    """``test_serve.py::test_prefill_decode_matches_forward[mamba2_1p3b]``
    on the port alone, with the port's own init."""
    m = tm2.SMOKE.model
    params = ttfm.init_model(0, m, device="cpu")
    toks = torch.from_numpy(_tokens(m.vocab, (B, S), seed=3))
    logits_fwd, _ = ttfm.forward(params, m, {"tokens": toks})
    s0 = S - 6
    lp, cache = tdec.prefill(params, m, {"tokens": toks[:, :s0]}, max_len=S)
    assert float((lp - logits_fwd[:, :s0]).abs().max()) < 2e-4
    for i in range(s0, S):
        ld, cache = tdec.decode_step(params, cache, toks[:, i:i + 1], i, m)
        err = float((ld[:, 0] - logits_fwd[:, i]).abs().max())
        assert err < 2e-4, (i, err)


def test_prefill_last_only():
    m = tm2.SMOKE.model
    params = ttfm.init_model(1, m, device="cpu")
    toks = torch.from_numpy(_tokens(m.vocab, (B, S), seed=4))
    full, _ = tdec.prefill(params, m, {"tokens": toks}, max_len=S)
    last, _ = tdec.prefill(params, m, {"tokens": toks}, max_len=S,
                           last_only=True)
    assert last.shape == (B, 1, m.vocab)
    assert float((last[:, 0] - full[:, -1]).abs().max()) < 1e-5


def test_generate_n_new_1_contract():
    """Exactly n_new tokens; token 0 is the argmax of the prefill's last
    position, so n_new=1 runs no decode step; n_new < 1 raises; a list of
    prompts goes through the engine and gives each prompt's own tokens."""
    m = tm2.SMOKE.model
    params = ttfm.init_model(4, m, device="cpu")
    prompt = torch.from_numpy(_tokens(m.vocab, (B, 8), seed=5))
    out1 = tdec.generate(params, m, prompt, n_new=1)
    assert out1.shape == (B, 1)
    logits, _ = tdec.prefill(params, m, {"tokens": prompt}, max_len=9,
                             last_only=True)
    assert bool((out1[:, 0] == torch.argmax(logits[:, -1], dim=-1)).all())
    out3 = tdec.generate(params, m, prompt, n_new=3)
    assert out3.shape == (B, 3)
    assert bool((out3[:, :1] == out1).all())
    assert bool(((out3 >= 0) & (out3 < m.vocab)).all())
    with pytest.raises(ValueError, match="n_new"):
        tdec.generate(params, m, prompt, n_new=0)
    ragged = tdec.generate(params, m, [prompt[0], prompt[1, :5]], n_new=3)
    assert ragged.shape == (2, 3)
    assert torch.equal(ragged[0], out3[0])
    assert torch.equal(ragged[1], tdec.generate(params, m, prompt[1:, :5],
                                                n_new=3)[0])


def test_decode_step_vector_index_matches_scalar():
    """A [B] index vector with every row at one position is bitwise the
    scalar path (logits and every cache leaf); so is the paged engine's
    step (``pages``) for the rows it marks active, written in place, while
    an inactive row's state is left as it was."""
    m = tm2.SMOKE.model
    params = ttfm.init_model(5, m, device="cpu")
    toks = torch.from_numpy(_tokens(m.vocab, (B, S), seed=6))
    _, cache = tdec.prefill(params, m, {"tokens": toks[:, :S - 2]},
                            max_len=S)
    ls, cs = tdec.decode_step(params, cache, toks[:, S - 2:S - 1], S - 2, m)
    lv, cv = tdec.decode_step(params, cache, toks[:, S - 2:S - 1],
                              torch.full((B,), S - 2), m)
    assert torch.equal(ls, lv)
    for a, b in zip(ttfm.tree_leaves(cs), ttfm.tree_leaves(cv)):
        assert torch.equal(a, b)
    paged = ttfm.tree_map(torch.clone, cache)
    pages = torch.ones((B, 1), dtype=torch.long)
    pages[-1] = 0                        # the last row is not decoding
    lp, cp = tdec.decode_step(params, paged, toks[:, S - 2:S - 1],
                              torch.full((B,), S - 2), m, pages=pages)
    assert cp is paged
    assert torch.equal(lp[:-1], ls[:-1])
    # one stacked stage: every leaf is [layers, B, ...]
    for a, b, c in zip(ttfm.tree_leaves(cs), ttfm.tree_leaves(cp),
                       ttfm.tree_leaves(cache)):
        assert torch.equal(b[:, :-1], a[:, :-1])
        assert torch.equal(b[:, -1:], c[:, -1:])


def test_bf16_decode_reads_a_rounded_history():
    """At bf16 compute the conv buffer is bf16 (as in JAX), so decode and
    forward differ by more than at f32; both stay within the bf16 bar."""
    errs = {}
    for name in ("f32", "bf16"):
        m = dataclasses.replace(tm2.SMOKE.model, dtype=DTYPES[name][1])
        params = ttfm.init_model(6, m, device="cpu")
        toks = torch.from_numpy(_tokens(m.vocab, (B, S), seed=7))
        fwd, _ = ttfm.forward(params, m, {"tokens": toks})
        _, cache = tdec.prefill(params, m, {"tokens": toks[:, :S - 4]},
                                max_len=S)
        assert cache[0]["l0"]["conv_buf"].dtype == DTYPES[name][1]
        err = 0.0
        for i in range(S - 4, S):
            ld, cache = tdec.decode_step(params, cache, toks[:, i:i + 1], i,
                                         m)
            err = max(err, float((ld[:, 0].float() - fwd[:, i].float()
                                  ).abs().max()))
        errs[name] = (err, float(fwd.float().abs().max()))
    assert errs["f32"][0] < F32_BAR
    assert errs["f32"][0] < errs["bf16"][0] <= BF16_REL * errs["bf16"][1]
