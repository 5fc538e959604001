"""Port parity for the encoder-decoder and frontend families: whisper-base
(``audio_stub`` frames, bidirectional encoder, cross attention, learned
decoder positions) and internvl2-76b (``vision_stub`` patch embeddings)
against the JAX package, at their ``SMOKE`` size with JAX's weights
carried across (``transformer.params_from_numpy``).

Bars are ``test_torch_attention.py``'s (the JAX serving suite's ``2e-4``
at f32; at bf16 ``BF16_REL`` of the largest magnitude plus the reach of
bf16 rounding, JAX's own bf16-vs-f32 distance). The engine is held to solo
``prefill`` + ``decode_step`` runs token for token, as
``tests/test_engine.py``'s enc-dec case holds JAX's, with its two
``ValueError``s. Full width is checked through shapes only (``jax.eval_
shape`` against the port's meta-device init).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_attention as ta  # noqa: E402
from test_torch_attention import jx  # noqa: E402,F401 (module fixture)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

B, S, ENC = 2, 12, 10
FULL_WIDTH_PARAMS = {"whisper_base": 87_409_152,
                     "internvl2_76b": 69_503_033_344}


def _frames(d, shape=(B, ENC), seed=0):
    return np.random.default_rng(seed).normal(size=shape + (d,)
                                              ).astype(np.float32)


def _batch(jm, toks, seed=0):
    """The numpy batch of the model's frontend: frames for whisper, the
    first ``n_vision_patches`` positions' embeddings for internvl2."""
    b = {"tokens": toks}
    if jm.frontend == "audio_stub":
        b["frames"] = _frames(jm.d_model, (toks.shape[0], ENC), seed)
    elif jm.frontend == "vision_stub":
        b["vision_embeds"] = _frames(
            jm.d_model, (toks.shape[0], jm.n_vision_patches), seed)
    return b


def _jb(jx, b):
    return {k: jx.jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ["whisper_base", "internvl2_76b"])
def test_every_arch_id_and_configs_equal_jax(jx, name):
    """``get_arch`` knows every id; the two new configs equal JAX's field
    by field (CONFIG and SMOKE), and ``lm_cells`` lists JAX's cells."""
    for a in tconfigs.ARCH_IDS + tconfigs.AUX_ARCH_IDS:
        assert tconfigs.get_arch(a).name == jx.get_arch(a).name
        assert tconfigs.get_arch(a, smoke=True).name == \
            jx.get_arch(a, smoke=True).name
    for smoke in (False, True):
        ta._same_config(jx, tconfigs.get_arch(name, smoke=smoke),
                        jx.get_arch(name, smoke=smoke))
    from repro.configs import lm_cells
    assert tconfigs.lm_cells() == lm_cells()


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_full_width_tree_without_allocating(jx, name):
    jm = jx.get_arch(name).model
    jshapes = jx.jax.eval_shape(lambda k: jx.tfm.init_model(k, jm),
                                jx.jax.random.PRNGKey(0))
    tp = ttfm.init_model(0, tconfigs.get_arch(name).model, device="meta")
    n = 0
    for path, jl, tl in ta._walk(jshapes, tp):
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert str(tl.dtype).split(".")[-1] == jx.jnp.dtype(jl.dtype).name
        n += math.prod(jl.shape)
    assert n == ttfm.count_params(tp) == FULL_WIDTH_PARAMS[name]


def _forward_case(jx, name, dtype_name, seed):
    jm, tm, jp, tp = ta._model(jx, name, dtype_name, seed=seed)
    b = _batch(jm, ta._tokens(jm.vocab, (B, S), seed), seed)
    want, jaux = jx.tfm.forward(jp, jm, _jb(jx, b))
    want32 = (None if dtype_name == "f32" else ta._np(jx, jx.tfm.forward(
        jp, ta._f32(jx, jm), _jb(jx, b))[0]))
    got, aux = ttfm.forward(tp, tm, _tb(b))
    assert got.dtype == ta._dtypes(jx, dtype_name)[1]
    ta._hold(got, ta._np(jx, want), dtype_name, "logits", want32)
    assert float(aux) == float(jaux) == 0.0
    return jm, tm, jp, tp, b


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["whisper_base", "internvl2_76b"])
def test_forward_matches_jax(jx, name, dtype_name):
    jm, tm, jp, tp, b = _forward_case(jx, name, dtype_name, seed=0)
    if name == "internvl2_76b":
        # the patch embeddings really replace the first positions
        plain = dict(b)
        del plain["vision_embeds"]
        assert not torch.equal(ttfm.forward(tp, tm, _tb(plain))[0],
                               ttfm.forward(tp, tm, _tb(b))[0])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_encode_matches_jax(jx, dtype_name):
    jm, tm, jp, tp = ta._model(jx, "whisper_base", dtype_name, seed=3)
    b = _batch(jm, ta._tokens(jm.vocab, (B, S), 3), 3)
    want = jx.tfm.encode(jp, jm, _jb(jx, b))
    want32 = (None if dtype_name == "f32" else
              ta._np(jx, jx.tfm.encode(jp, ta._f32(jx, jm), _jb(jx, b))))
    got = ttfm.encode(tp, tm, _tb(b))
    assert got.shape == (B, ENC, jm.d_model)
    ta._hold(got, ta._np(jx, want), dtype_name, "encode", want32)


def _serve(pkg, params, cfg, b, s0, max_len, totensor):
    """Prefill over tokens[:, :s0] (with the frontend's inputs) and decode
    steps over the rest: [(logits, cache)] per step."""
    toks = b["tokens"]
    first = dict(b, tokens=toks[:, :s0])
    lg, c = pkg.prefill(params, cfg, {k: totensor(v) for k, v in
                                      first.items()}, max_len=max_len)
    out = [(lg, c)]
    for i in range(s0, toks.shape[1]):
        lg, c = pkg.decode_step(params, c, totensor(toks[:, i:i + 1]), i,
                                cfg)
        out.append((lg, c))
    return out


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["whisper_base", "internvl2_76b"])
def test_prefill_and_decode_match_jax(jx, name, dtype_name):
    """Logits and every cache leaf (whisper's cross K/V included) after
    prefill and after each of four decode steps."""
    jm, tm, jp, tp = ta._model(jx, name, dtype_name, seed=1)
    b = _batch(jm, ta._tokens(jm.vocab, (B, S), 1), 1)
    s0 = S - 4
    want = _serve(jx.dec, jp, jm, b, s0, S, jx.jnp.asarray)
    want32 = (None if dtype_name == "f32" else
              _serve(jx.dec, jp, ta._f32(jx, jm), b, s0, S, jx.jnp.asarray))
    got = _serve(tdec, tp, tm, b, s0, S, torch.from_numpy)
    for step, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        jl32, jc32 = (None, None) if want32 is None else want32[step]
        ta._hold(tl, ta._np(jx, jl), dtype_name, ("logits", step),
                 None if jl32 is None else ta._np(jx, jl32))
        leaves32 = (None if jc32 is None else
                    [ta._np(jx, a) for _, a, _ in ta._walk(jc32, tc)])
        paths = []
        for n, (path, a, t) in enumerate(ta._walk(jc, tc)):
            paths.append(path[-1])
            assert str(t.dtype).split(".")[-1] == jx.jnp.dtype(a.dtype).name
            ta._hold(t, ta._np(jx, a), dtype_name, (step, path),
                     None if leaves32 is None else leaves32[n])
        if name == "whisper_base":
            assert {"ck", "cv"} <= set(paths)


def test_engine_frames_against_solo_runs(jx):
    """Whisper through the engine: frames ride in on ``Request.frames``; a
    request's tokens equal its solo ``prefill`` + ``decode_step`` run; a
    short and a missing frames are refused with JAX's texts."""
    jm, tm, jp, tp = ta._model(jx, "whisper_base", "f32", seed=2)
    enc_len, max_len = 12, 12
    rng = np.random.RandomState(0)
    frames = [rng.randn(enc_len, tm.d_model).astype(np.float32)
              for _ in range(3)]
    prompts = [rng.randint(0, tm.vocab, size=(s,)) for s in (4, 6, 5)]
    eng = Engine(tp, tm, n_slots=2, max_len=max_len, enc_len=enc_len,
                 device="cpu")
    with pytest.raises(ValueError, match="frames length"):
        eng.submit(Request(rid="short", tokens=prompts[0], max_new=2,
                           frames=frames[0][: enc_len - 4]))
    with pytest.raises(ValueError, match="no frames"):
        eng.submit(Request(rid="missing", tokens=prompts[0], max_new=2))
    reqs = [Request(rid=i, tokens=p, max_new=4, frames=f, arrival=i)
            for i, (p, f) in enumerate(zip(prompts, frames))]
    comps = eng.run(reqs)
    assert len(comps) == 3
    for c in comps:
        logits, cache = tdec.prefill(
            tp, tm, {"tokens": torch.from_numpy(prompts[c.rid])[None],
                     "frames": torch.from_numpy(frames[c.rid])[None]},
            max_len=max_len, last_only=True)
        tok = int(torch.argmax(logits[0, -1]))
        ref = [tok]
        i = len(prompts[c.rid])
        for _ in range(3):
            lg, cache = tdec.decode_step(tp, cache, torch.tensor([[tok]]),
                                         i, tm)
            tok = int(torch.argmax(lg[0, -1]))
            ref.append(tok)
            i += 1
        assert list(c.tokens) == ref, (c.rid, list(c.tokens), ref)
    # and JAX's engine on the same weights and requests gives the same
    from repro.serve.engine import Engine as JEngine
    from repro.serve.scheduler import Request as JRequest
    jeng = JEngine(jp, jm, n_slots=2, max_len=max_len, enc_len=enc_len)
    jcomps = jeng.run([JRequest(rid=i, tokens=p, max_new=4, frames=f,
                                arrival=i)
                       for i, (p, f) in enumerate(zip(prompts, frames))])
    assert {c.rid: list(c.tokens) for c in comps} == \
        {c.rid: list(map(int, c.tokens)) for c in jcomps}
    assert eng.stats.prefills == jeng.stats.prefills == 3


def test_encoder_layers_are_bidirectional_and_cross_has_no_bias(jx):
    """The encoder's stages are ``bidir`` + ``mlp``, every decoder layer
    has cross attention, and a qkv-biased config keeps its biases out of
    the cross projections (JAX's ``_init_attn(cross=True)``)."""
    tm = tconfigs.get_arch("whisper_base", smoke=True).model
    assert all(sp == ttfm.LayerSpec("bidir", "mlp")
               for st in ttfm.stages_for(tm, encoder=True) for sp in st.block)
    assert all(sp.cross_attn for st in ttfm.stages_for(tm)
               for sp in st.block)
    biased = dataclasses.replace(tm, qkv_bias=True)
    tp = ttfm.init_model(0, biased, device="meta")
    jp = jx.jax.eval_shape(
        lambda k: jx.tfm.init_model(k, dataclasses.replace(
            jx.get_arch("whisper_base", smoke=True).model, qkv_bias=True)),
        jx.jax.random.PRNGKey(0))
    lp = tp["stages"][0]["l0"]
    assert "bq" in lp["attn"] and "bq" not in lp["cross"]
    assert set(lp["cross"]) == set(jp["stages"][0]["l0"]["cross"])
