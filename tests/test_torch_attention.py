"""Port parity for the attention stack (``models/attention.py``) and the
dense attention LMs built on it (mistral-nemo-12b, phi3-medium-14b,
qwen2-72b, nemotron-4-340b) against the JAX package.

Inputs are made with numpy from a seed; JAX-initialised parameters are
carried across with ``transformer.params_from_numpy``. Models run at their
``SMOKE`` size; full width is checked only through parameter shapes
(``jax.eval_shape`` against the port's meta-device init).

Bars:
* attention functions: ``atol 1e-5, rtol 1e-5`` at f32 (f32 sums in
  another order); at bf16 inputs, ``BF16_REL`` (four bf16 steps) of the
  largest magnitude, as ``test_torch_lm.py`` rules;
* models: ``test_torch_lm.py``'s bars: ``2e-4`` on logits and cache leaves
  at f32 with greedy tokens identical; at bf16 compute ``BF16_REL`` of the
  largest magnitude, and greedy tokens equal up to the first step where
  JAX's top-1 logit leads its top-2 by no more than that bar. At bf16 the
  leaf's bar adds the reach of bf16 rounding on the same weights and
  tokens, the distance of JAX's own bf16 result from its f32 result (the
  rule of ``chip_smoke.py`` phase 8): the two packages round at the same
  places (the activations are written op by op as XLA lowers them), but
  after f32 sums taken in another order one rounding can move by a bf16
  step, and an attention model rounds q, k, v, the attention output and
  the MLP's hidden state in every layer, so the steps carried on reach
  past four (five on mistral's SMOKE decode logits).

``cuda``-marked cases hold the port on the card against the port on the CPU
and import no JAX: ``python -m pytest -q -m cuda tests/test_torch_attention.py``.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402

F32_BAR = 2e-4
BF16_REL = 2 ** -6
ATOL = RTOL = 1e-5
DENSE = ["mistral_nemo_12b", "phi3_medium_14b", "qwen2_72b",
         "nemotron_4_340b"]
FULL_WIDTH_PARAMS = {"kan_llm": 3_926_272,
                     "mistral_nemo_12b": 11_576_693_760,
                     "phi3_medium_14b": 14_879_708_160,
                     "qwen2_72b": 72_706_203_648,
                     "nemotron_4_340b": 341_025_638_400}
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs on the CPU: the suite
    runs several pytest workers at once, and every worker's torch threads
    contending for the same cores made second-long tests take minutes."""
    n = torch.get_num_threads()
    if not torch.cuda.is_available():
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import attention, transformer
    from repro.serve import decode
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 attn=attention, tfm=transformer, dec=decode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tn(t):
    return t.detach().float().cpu().numpy()


def _np(jx, a):
    return np.asarray(jx.jnp.asarray(a).astype(jx.jnp.float32))


def _dtypes(jx, name):
    return {"f32": (jx.jnp.float32, torch.float32),
            "bf16": (jx.jnp.bfloat16, torch.bfloat16)}[name]


def _hold(got, want, dtype_name, what="", want_f32=None):
    """``got`` (port) against ``want`` (JAX, numpy f32) at the model bars;
    at bf16 ``want_f32`` is JAX's result at f32 compute (the reach)."""
    got = _tn(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype_name == "f32":
        bar = F32_BAR
    else:
        bar = (BF16_REL * float(np.abs(want).max())
               + float(np.abs(want - want_f32).max()))
    err = float(np.abs(got.astype(np.float32) - want).max())
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


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


# --- the attention functions -------------------------------------------------

def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _attn_hold(jx, got, want, dtype_name, what=""):
    want = _np(jx, want)
    got = _tn(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=str(what))
    else:
        bar = BF16_REL * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bar, what


def _both(jx, arrays, dtype_name):
    jdt, tdt = _dtypes(jx, dtype_name)
    return ([jx.jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# (S, T, Hq, Kv, hd, kw): causal and bidirectional, T a multiple of the
# chunk or not, queries at an offset, keys past a valid length, MHA/GQA/MQA
CHUNKED_CASES = [
    (24, 24, 4, 2, 8, dict(causal=True, kv_chunk=8)),
    (21, 21, 8, 2, 8, dict(causal=True, kv_chunk=8)),
    (21, 21, 4, 4, 16, dict(causal=False, kv_chunk=8)),
    (6, 11, 4, 1, 8, dict(causal=True, q_offset=5, kv_chunk=4)),
    (4, 20, 6, 2, 8, dict(causal=True, q_offset=9, kv_valid_len=13,
                          kv_chunk=8)),
    (5, 19, 4, 2, 8, dict(causal=False, kv_valid_len=7, kv_chunk=512)),
    (3, 9, 4, 2, 8, dict(causal=True, q_offset=-2, kv_chunk=4)),
]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CHUNKED_CASES)))
def test_chunked_attention_matches_jax(jx, case, dtype_name):
    s, t, hq, kv, hd, kw = CHUNKED_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(
        jx, _qkv((B, s, hq, hd), (B, t, kv, hd), case), dtype_name)
    want = jx.attn.chunked_attention(jq, jk, jv, **kw)
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    _attn_hold(jx, got, want, dtype_name, kw)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("s,window,hq,kv", [
    (21, 8, 4, 2), (16, 8, 4, 4), (5, 8, 6, 2), (40, 16, 4, 1)])
def test_windowed_attention_matches_jax(jx, s, window, hq, kv, dtype_name):
    (jq, jk, jv), (tq, tk, tv) = _both(
        jx, _qkv((B, s, hq, 8), (B, s, kv, 8), s + window), dtype_name)
    want = jx.attn.windowed_attention(jq, jk, jv, window=window)
    got = tattn.windowed_attention(tq, tk, tv, window=window)
    _attn_hold(jx, got, want, dtype_name, (s, window))
    if dtype_name == "f32" and s >= window:
        # the band: each position sees exactly the window's keys
        ref = tattn.chunked_attention(tq, tk, tv, causal=True)
        assert torch.allclose(got[:, :window], ref[:, :window], atol=1e-5)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("index", [5, 13, 30, (3, 16)])
def test_decode_attention_matches_jax(jx, index, rolling, dtype_name):
    """Scalar and [B] cache counts; a rolling cache takes min(index, T)."""
    t = 16
    (jq, jk, jv), (tq, tk, tv) = _both(
        jx, _qkv((B, 1, 4, 8), (B, t, 2, 8), 7), dtype_name)
    idx = np.asarray(index, dtype=np.int32)
    if not rolling and idx.max() > t:
        idx = np.minimum(idx, t)
    jidx = jx.jnp.asarray(idx)
    tidx = int(idx) if idx.ndim == 0 else torch.from_numpy(idx)
    want = jx.attn.decode_attention(jq, jk, jv, jidx, rolling=rolling)
    got = tattn.decode_attention(tq, tk, tv, tidx, rolling=rolling)
    _attn_hold(jx, got, want, dtype_name, (index, rolling))
    if idx.ndim == 0:      # a scalar tensor count is the int count
        again = tattn.decode_attention(tq, tk, tv, torch.tensor(int(idx)),
                                       rolling=rolling)
        assert torch.equal(again, got)


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("index", [0, 7, 15, 21, (2, 19)])
def test_cache_update_matches_jax(jx, index, rolling):
    """One token written at index (mod T when rolling; clamped to T - 1
    past the end otherwise, as ``dynamic_update_slice`` clamps), for the
    whole batch or per row; the caches given are left as they were."""
    t = 16
    rng = np.random.default_rng(3)
    kc, vc = (rng.normal(size=(B, t, 2, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(B, 1, 2, 8)).astype(np.float32)
              for _ in range(2))
    idx = np.asarray(index, dtype=np.int32)
    jk, jv = jx.attn.cache_update(*(jx.jnp.asarray(a) for a in
                                    (kc, vc, kn, vn)), jx.jnp.asarray(idx),
                                  rolling=rolling)
    tkc = torch.from_numpy(kc.copy())
    tidx = int(idx) if idx.ndim == 0 else torch.from_numpy(idx)
    tk, tv = tattn.cache_update(tkc, torch.from_numpy(vc),
                                torch.from_numpy(kn), torch.from_numpy(vn),
                                tidx, rolling=rolling)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tkc.numpy(), kc)


def test_fully_masked_rows_are_uniform_not_nan():
    """NEG_INF is -1e30, not -inf: a query with no visible key averages V
    (the reference's behaviour), in chunked and decode attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 3, 2, 4),
                                                 (1, 6, 2, 4), 11))
    out = tattn.chunked_attention(q, k, v, causal=True, q_offset=-10,
                                  kv_chunk=4)
    assert torch.isfinite(out).all()
    # every masked score gets weight 1 until a real score arrives; with
    # none, all 8 slots of the two chunks count, the 2 zero-padded ones too
    torch.testing.assert_close(out[0, 0, 0], v[0, :, 0].sum(0) / 8)
    dec = tattn.decode_attention(q[:, :1], k, v, 0)
    torch.testing.assert_close(dec[0, 0, 0], v[0, :, 0].mean(0))


@given(st.integers(1, 3), st.integers(4, 24))
@settings(max_examples=10, deadline=None)
def test_attention_is_convex_combination(seed, t):
    """The twin of ``test_properties.py``'s case: each output lies in the
    convex hull of V's rows, so within V's per-feature min and max."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, t, 2, 8), (1, t, 2, 8),
                                                 seed))
    out = tattn.chunked_attention(q, k, v, causal=True, kv_chunk=4)
    vmax = v.amax(dim=1, keepdim=True)
    vmin = v.amin(dim=1, keepdim=True)
    assert bool((out <= vmax + 1e-4).all())
    assert bool((out >= vmin - 1e-4).all())


# --- configs -----------------------------------------------------------------

def _same_config(jx, tcfg, jcfg):
    tmap = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for f in dataclasses.fields(jcfg):
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "model":
            _same_config(jx, tv, jv)
        elif f.name in ("dtype", "param_dtype", "grad_dtype"):
            assert tmap[tv] == jx.jnp.dtype(jv).name, f.name
        elif f.name in ("block_pattern", "first_layers"):
            assert [dataclasses.asdict(s) for s in tv] == [
                dataclasses.asdict(s) for s in jv], f.name
        else:
            assert tv == jv, (f.name, tv, jv)
    assert {f.name for f in dataclasses.fields(tcfg)} == {
        f.name for f in dataclasses.fields(jcfg)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", DENSE + ["kan_llm", "kan_llm_int8"])
def test_configs_equal_jax(jx, name, smoke):
    tcfg = tconfigs.get_arch(name, smoke=smoke)
    _same_config(jx, tcfg, jx.get_arch(name, smoke=smoke))
    assert tcfg.shapes() == jx.get_arch(name).shapes()


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_full_width_parameter_count_without_allocating(jx, name):
    """Leaf for leaf the JAX layout's shapes and dtypes at full width:
    ``jax.eval_shape`` on one side, a meta-device init on the other."""
    jm = jx.get_arch(name).model
    jshapes = jx.jax.eval_shape(lambda k: jx.tfm.init_model(k, jm),
                                jx.jax.random.PRNGKey(0))
    tp = ttfm.init_model(0, tconfigs.get_arch(name).model, device="meta")
    n = 0
    for path, jl, tl in _walk(jshapes, tp):
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert str(tl.dtype).split(".")[-1] == jx.jnp.dtype(jl.dtype).name
        assert tl.device.type == "meta"
        n += math.prod(jl.shape)
    assert n == ttfm.count_params(tp) == FULL_WIDTH_PARAMS[name]


# --- the dense models against JAX ---------------------------------------------

def _model(jx, name, dtype_name, seed=0, **overrides):
    jdt, tdt = _dtypes(jx, dtype_name)
    jm = dataclasses.replace(jx.get_arch(name, smoke=True).model, dtype=jdt,
                             **overrides)
    tm = dataclasses.replace(tconfigs.get_arch(name, smoke=True).model,
                             dtype=tdt, **overrides)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


def _f32(jx, jm):
    return dataclasses.replace(jm, dtype=jx.jnp.float32)


def _forward_case(jx, jm, tm, jp, tp, dtype_name, toks):
    want, jaux = jx.tfm.forward(jp, jm, {"tokens": jx.jnp.asarray(toks)})
    want32 = (None if dtype_name == "f32" else _np(jx, jx.tfm.forward(
        jp, _f32(jx, jm), {"tokens": jx.jnp.asarray(toks)})[0]))
    got, aux = ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == _dtypes(jx, dtype_name)[1]
    _hold(got, _np(jx, want), dtype_name, "logits", want32)
    assert float(aux) == float(jaux) == 0.0


def _jax_serve(jx, jm, jp, toks, s0):
    """JAX's prefill over ``toks[:, :s0]`` and decode steps over the rest:
    [(logits, cache)] per step, numpy f32."""
    s = toks.shape[1]
    jl, jc = jx.dec.prefill(jp, jm, {"tokens": jx.jnp.asarray(toks[:, :s0])},
                            max_len=s)
    out = [(jl, jc)]
    for i in range(s0, s):
        jl, jc = jx.dec.decode_step(jp, jc, jx.jnp.asarray(toks[:, i:i + 1]),
                                    i, jm)
        out.append((jl, jc))
    return [(_np(jx, lg), jx.jax.tree.map(lambda a: a, c)) for lg, c in out]


def _serve_case(jx, jm, tm, jp, tp, dtype_name, toks, s0):
    """Logits and every cache leaf after prefill and after each decode
    step of the rest of ``toks``."""
    s = toks.shape[1]
    want = _jax_serve(jx, jm, jp, toks, s0)
    want32 = (None if dtype_name == "f32" else
              _jax_serve(jx, _f32(jx, jm), jp, toks, s0))
    tl, tc = tdec.prefill(tp, tm, {"tokens": torch.from_numpy(toks[:, :s0])},
                          max_len=s)
    got = [(tl, tc)]
    for i in range(s0, s):
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                  i, tm)
        got.append((tl, tc))
    for step, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        jl32, jc32 = (None, None) if want32 is None else want32[step]
        _hold(tl, jl, dtype_name, ("logits", step), jl32)
        leaves32 = (None if jc32 is None else
                    [_np(jx, a) for _, a, _ in _walk(jc32, tc)])
        for n, (path, a, b) in enumerate(_walk(jc, tc)):
            assert str(b.dtype).split(".")[-1] == jx.jnp.dtype(a.dtype).name
            _hold(b, _np(jx, a), dtype_name, (step, path),
                  None if leaves32 is None else leaves32[n])


def _first_step_without_lead(jx, jp, jm, prompt, toks, bar):
    """The first generated step where JAX's top-1 logit leads its top-2 by
    no more than ``bar`` (teacher-forced on JAX's own tokens)."""
    logits, cache = jx.dec.prefill(jp, jm, {"tokens": prompt},
                                   prompt.shape[1] + toks.shape[1])
    steps = [logits[:, -1]]
    for i in range(toks.shape[1] - 1):
        logits, cache = jx.dec.decode_step(jp, cache, toks[:, i:i + 1],
                                           prompt.shape[1] + i, jm)
        steps.append(logits[:, 0])
    for i, lg in enumerate(steps):
        top2 = np.sort(_np(jx, lg), axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] <= bar):
            return i
    return len(steps)


def _generate_case(jx, jm, tm, jp, tp, dtype_name, prompt, n_new=8):
    want = np.asarray(jx.dec.generate(jp, jm, jx.jnp.asarray(prompt),
                                      n_new=n_new))
    got = tdec.generate(tp, tm, torch.from_numpy(prompt), n_new=n_new
                        ).numpy()
    assert got.shape == want.shape == (prompt.shape[0], n_new)
    if dtype_name == "f32":
        np.testing.assert_array_equal(got, want)
        return
    lead_until = _first_step_without_lead(
        jx, jp, jm, jx.jnp.asarray(prompt), jx.jnp.asarray(want),
        BF16_REL * 8)
    np.testing.assert_array_equal(got[:, :lead_until], want[:, :lead_until])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_jax(jx, name, dtype_name):
    jm, tm, jp, tp = _model(jx, name, dtype_name)
    _forward_case(jx, jm, tm, jp, tp, dtype_name,
                  _tokens(jm.vocab, (B, S)))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_jax(jx, name, dtype_name):
    jm, tm, jp, tp = _model(jx, name, dtype_name, seed=1)
    _serve_case(jx, jm, tm, jp, tp, dtype_name,
                _tokens(jm.vocab, (B, S), seed=1), S - 6)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_generate_matches_jax(jx, name, dtype_name):
    jm, tm, jp, tp = _model(jx, name, dtype_name, seed=2)
    _generate_case(jx, jm, tm, jp, tp, dtype_name,
                   _tokens(jm.vocab, (B, 8), seed=2))


# mixers other than full attention, through replaced block patterns (a
# window of 16 and prompts longer than it); bidir is skipped by prefill and
# decode in both packages (it serves encoders)
PATTERNS = {
    "swa": dict(block_pattern=None, window=16),
    "local": dict(block_pattern=None, local_window=16),
    "bidir": dict(block_pattern=None),
    "attn+swa": dict(block_pattern=("attn", "swa"), window=16),
}


def _pattern_model(jx, kind, dtype_name, seed):
    kw = dict(PATTERNS[kind])
    mixers = kw.pop("block_pattern") or (kind,)
    jspecs = tuple(jx.tfm.LayerSpec(m, "mlp") for m in mixers)
    tspecs = tuple(ttfm.LayerSpec(m, "mlp") for m in mixers)
    jdt, tdt = _dtypes(jx, dtype_name)
    base = tconfigs.get_arch("mistral_nemo_12b", smoke=True).model
    jm = dataclasses.replace(
        jx.get_arch("mistral_nemo_12b", smoke=True).model, dtype=jdt,
        block_pattern=jspecs, n_layers=2 * len(mixers), **kw)
    tm = dataclasses.replace(base, dtype=tdt, block_pattern=tspecs,
                             n_layers=2 * len(mixers), **kw)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(PATTERNS))
def test_window_and_bidir_mixers_match_jax(jx, kind, dtype_name):
    """Forward over 40 tokens; prefill of 30 (the ring keeps the last 16 in
    slot order i mod 16, slot for slot as JAX) and 10 decode steps; then
    generate from 20."""
    jm, tm, jp, tp = _pattern_model(jx, kind, dtype_name, seed=3)
    toks = _tokens(jm.vocab, (B, 40), seed=3)
    _forward_case(jx, jm, tm, jp, tp, dtype_name, toks)
    _serve_case(jx, jm, tm, jp, tp, dtype_name, toks, 30)
    _generate_case(jx, jm, tm, jp, tp, dtype_name, toks[:, :20], n_new=6)


@pytest.mark.parametrize("prescan", [False, True])
def test_prescan_cast_forward_at_bf16(jx, prescan):
    """``prescan_cast`` casts every f32 leaf of the stages (norm scales
    included) to bf16 before the layers, in ``forward`` only. With norm
    scales that bf16 does not hold exactly, each setting matches JAX's and
    the two settings give different logits."""
    jm, tm, jp, tp = _model(jx, "qwen2_72b", "bf16", seed=4,
                            prescan_cast=prescan)
    rng = np.random.default_rng(4)
    jp = jx.jax.tree_util.tree_map_with_path(
        lambda path, a: (jx.jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                                        .astype(np.float32))
                         if "scale" in str(path[-1]) else a), jp)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    toks = _tokens(jm.vocab, (B, S), seed=4)
    _forward_case(jx, jm, tm, jp, tp, "bf16", toks)
    cast = ttfm.prescan_cast(tp["stages"], tm)
    for a, b in zip(ttfm.tree_leaves(tp["stages"]), ttfm.tree_leaves(cast)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, a.to(torch.bfloat16))
    f32 = dataclasses.replace(tm, dtype=torch.float32)
    same = ttfm.prescan_cast(tp["stages"], f32)
    assert all(a is b for a, b in zip(ttfm.tree_leaves(tp["stages"]),
                                      ttfm.tree_leaves(same)))
    other = dataclasses.replace(tm, prescan_cast=not prescan)
    a, _ = ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    b, _ = ttfm.forward(tp, other, {"tokens": torch.from_numpy(toks)})
    assert not torch.equal(a, b)


def test_padded_heads_regroup_as_in_the_reference(jx):
    """phi3's full head counts (40 q / 10 kv, padded to 48 / 16) at a narrow
    width. The reference groups query heads by the PADDED counts (head h
    reads kv head h // 3, not h // 4), so real heads 30-39 read zero kv
    heads and give exactly 0. The port reproduces that deviation: it is
    held to JAX, and exactly 10 real heads are inert."""
    over = dict(n_heads=40, n_kv_heads=10, head_dim=8, d_model=64,
                pad_attn_heads=16, n_layers=1)
    jm, tm, jp, tp = _model(jx, "phi3_medium_14b", "f32", seed=5, **over)
    assert (tm.padded_heads, tm.padded_kv_heads) == (48, 16)
    toks = _tokens(jm.vocab, (B, S), seed=5)
    _forward_case(jx, jm, tm, jp, tp, "f32", toks)
    # the attention heads of layer 0, as the model computes them
    lp = tp["stages"][0]["l0"]
    x = ttfm.embed_inputs(tp, tm, {"tokens": torch.from_numpy(toks)})
    xn = ttfm.layers.NORM_APPLY[tm.norm](lp["mixer_norm"], x)
    q, k, v = ttfm.qkv(lp, xn, tm)
    pos = torch.arange(S)
    q = ttfm.layers.apply_rope(q, pos, tm.rope_theta)
    k = ttfm.layers.apply_rope(k, pos, tm.rope_theta)
    o = tattn.chunked_attention(q, k, v, causal=True)
    jo = jx.attn.chunked_attention(*(jx.jnp.asarray(a.numpy())
                                     for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    inert = [h for h in range(tm.n_heads) if not bool(o[:, :, h].any())]
    assert inert == list(range(30, 40))
    # against the unpadded grouping (h // 4): exactly the heads whose kv
    # head moved give other outputs
    ref = tattn.chunked_attention(q[:, :, :40], k[:, :, :10], v[:, :, :10],
                                  causal=True)
    differ = [h for h in range(40) if not torch.allclose(o[:, :, h],
                                                          ref[:, :, h])]
    assert differ == [h for h in range(40) if h // 3 != h // 4]


def test_packed_init_and_cross_attention_are_ported():
    """Parameters packed for more than one model shard (a mesh's model
    axis) pack only MoE experts: a dense model's are the same draws at any
    ``n_model``; cross attention and the encoder-decoder family are ported
    (their parity is ``test_torch_encdec.py``'s)."""
    cfg = dataclasses.replace(
        tconfigs.get_arch("mistral_nemo_12b", smoke=True).model,
        block_pattern=(ttfm.LayerSpec("attn", "mlp", cross_attn=True),))
    one = ttfm.tree_leaves(ttfm.init_model(0, cfg, device="cpu"))
    two = ttfm.tree_leaves(ttfm.init_model(0, cfg, device="cpu", n_model=2))
    assert len(one) == len(two)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert "cross" in ttfm.init_model(0, cfg, device="cpu"
                                      )["stages"][0]["l0"]
    assert "enc_stages" in ttfm.init_model(
        0, dataclasses.replace(cfg, family="encdec", n_enc_layers=1),
        device="cpu")


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True, kv_chunk=512),
                                dict(causal=False, kv_chunk=96),
                                dict(causal=True, q_offset=100,
                                     kv_valid_len=300, kv_chunk=128)])
def test_chunked_attention_on_the_card_matches_the_cpu(cuda, kw):
    """f32 with TF32 off (``repro_torch`` sets it): the card's products sum
    in another order than the CPU's, within ``atol 1e-5, rtol 1e-5``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 333, 8, 64),
                                                 (2, 333, 2, 64), 9))
    want = tattn.chunked_attention(q, k, v, **kw)
    got = tattn.chunked_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)
