"""Port parity for the RG-LRU block (``models/rglru.py``) and recurrentgemma-2b
(RG-LRU + local attention) against the JAX package.

Inputs are made with numpy from a seed; JAX-initialised parameters are
carried across with ``transformer.params_from_numpy``. The model runs at its
``SMOKE`` size; full width is checked through parameter shapes only.

Bars:
* the gates, the scan, the step and both block applies: ``rtol 2e-5, atol
  2e-6`` at f32 (the JAX serving suite's bar for its chunked RG-LRU
  prefill, ``tests/test_paged_cache.py``). The port's scan doubles over T
  where ``jax.lax.associative_scan`` builds another tree, so the two differ
  at float epsilon;
* the model: ``test_torch_attention.py``'s bars (``2e-4`` at f32 with
  greedy tokens identical; at bf16 compute four bf16 steps of the largest
  magnitude plus JAX's own bf16-vs-f32 reach, and greedy tokens up to the
  first near tie), through that file's helpers. The prompts are longer than
  the local window (16), and one is exactly as long, so every decode step
  writes over the attention ring, as at full width (prompt 2048, window
  2048).

``cuda``-marked cases hold the port on the card against the port on the
CPU and import no JAX: ``python -m pytest -q -m cuda
tests/test_torch_rglru.py``.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_attention as ta  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=2e-5, atol=2e-6)
NAME = "recurrentgemma_2b"
FULL_WIDTH_PARAMS = 2_894_528_000
B, D, DR = 2, 24, 16


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases (with the names
    ``test_torch_attention``'s helpers read)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import attention, rglru, transformer
    from repro.serve import decode
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 attn=attention, tfm=transformer, dec=decode,
                                 rglru=rglru)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(jx, seed=0):
    """JAX block params with nonzero gate biases, and the port's copy."""
    cfg = jx.rglru.RGLRUConfig(d_model=D, d_rnn=DR)
    jp = jx.rglru.init_rglru_block(jx.jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    jp = dict(jp, b_a=jx.jnp.asarray(rng.normal(size=DR).astype(np.float32)),
              b_x=jx.jnp.asarray(rng.normal(size=DR).astype(np.float32)))
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return cfg, trg.RGLRUConfig(d_model=D, d_rnn=DR), jp, tp


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=str(what), **TOL)


def test_gates_match_jax(jx):
    _, _, jp, tp = _block(jx)
    u = _normal((B, 7, DR), 1)
    ja, jb = jx.rglru._gates(jp, jx.jnp.asarray(u))
    ta_, tb = trg._gates(tp, torch.from_numpy(u))
    assert ta_.dtype == tb.dtype == torch.float32
    _close(ta_, ja, "a")
    _close(tb, jb, "gated input")
    assert bool(((ta_ > 0) & (ta_ < 1)).all())


@pytest.mark.parametrize("t", [1, 2, 37, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_jax(jx, t, with_h0):
    """T of 1, 2, odd and long (9 doubling steps), with and without a
    carried state."""
    _, _, jp, tp = _block(jx, seed=t)
    u = _normal((B, t, DR), t)
    h0 = _normal((B, DR), t + 1) if with_h0 else None
    want = jx.rglru.rglru_scan(jp, jx.jnp.asarray(u),
                               None if h0 is None else jx.jnp.asarray(h0))
    got = trg.rglru_scan(tp, torch.from_numpy(u),
                         None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (B, t, DR) and got.dtype == torch.float32
    _close(got, want, (t, with_h0))


def test_scan_equals_the_sequential_recurrence(jx):
    """The doubling scan against ``h_t = a_t h_{t-1} + b_t`` step by step
    (``rglru_step``), and a two-segment carry (``h0`` = the first
    segment's last state) against the whole sequence."""
    _, _, _, tp = _block(jx, seed=5)
    u = torch.from_numpy(_normal((B, 45, DR), 5))
    h = trg.rglru_scan(tp, u)
    h_prev = torch.zeros((B, DR))
    for i in range(u.shape[1]):
        h_prev, _ = trg.rglru_step(tp, u[:, i], h_prev)
        torch.testing.assert_close(h[:, i], h_prev, **TOL)
    first = trg.rglru_scan(tp, u[:, :19])
    second = trg.rglru_scan(tp, u[:, 19:], first[:, -1])
    torch.testing.assert_close(torch.cat([first, second], 1), h, **TOL)
    # and JAX's two segments against the port's
    jh1 = jx.rglru.rglru_scan(jx.jax.tree.map(jx.jnp.asarray, {
        k: v.numpy() for k, v in tp.items()}), jx.jnp.asarray(u.numpy()
                                                              [:, :19]))
    _close(first, jh1, "first segment")


def test_step_matches_jax(jx):
    _, _, jp, tp = _block(jx, seed=2)
    u, h = _normal((B, DR), 2), _normal((B, DR), 3)
    jh, jy = jx.rglru.rglru_step(jp, jx.jnp.asarray(u), jx.jnp.asarray(h))
    th, ty = trg.rglru_step(tp, torch.from_numpy(u), torch.from_numpy(h))
    _close(th, jh)
    assert ty is th


def test_block_matches_jax(jx):
    jcfg, tcfg, jp, tp = _block(jx, seed=3)
    x = _normal((B, 21, D), 3)
    want = jx.rglru.apply_rglru_block(jp, jx.jnp.asarray(x), jcfg)
    got = trg.apply_rglru_block(tp, torch.from_numpy(x), tcfg)
    _close(got, want)


@pytest.mark.parametrize("buf_dtype", ["f32", "bf16"])
def test_block_decode_matches_jax(jx, buf_dtype):
    """One token against a random cache; the conv history joined in the
    buffer's dtype (at bf16 the new input rounds there)."""
    jcfg, tcfg, jp, tp = _block(jx, seed=4)
    jdt, tdt = ta._dtypes(jx, buf_dtype)
    x = _normal((B, 1, D), 4)
    h = _normal((B, DR), 5)
    buf = _normal((B, 3, DR), 6)
    jy, jc = jx.rglru.apply_rglru_block_decode(
        jp, jx.jnp.asarray(x), {"h": jx.jnp.asarray(h),
                                "conv_buf": jx.jnp.asarray(buf).astype(jdt)},
        jcfg)
    ty, tc = trg.apply_rglru_block_decode(
        tp, torch.from_numpy(x), {"h": torch.from_numpy(h),
                                  "conv_buf": torch.from_numpy(buf).to(tdt)},
        tcfg)
    _close(ty, jy)
    _close(tc["h"], jc["h"])
    # the history moves by one slot; the new slot is x @ w_main (f32 sums
    # in another order), rounded to the buffer's dtype
    assert tc["conv_buf"].dtype == tdt
    np.testing.assert_array_equal(tc["conv_buf"][:, :2].float().numpy(),
                                  ta._np(jx, jc["conv_buf"])[:, :2])
    new, jnew = tc["conv_buf"][:, 2].float(), ta._np(jx, jc["conv_buf"][:, 2])
    if buf_dtype == "f32":
        _close(new, jnew)
    else:
        assert float(np.abs(new.numpy() - jnew).max()) <= (
            2 ** -8 * float(np.abs(jnew).max()))


# --- recurrentgemma-2b -------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_registry_and_check_ported(jx, smoke):
    """The registry serves recurrentgemma (the port's config equal to
    JAX's, field by field), and ``check_ported`` takes its layers."""
    assert NAME in tconfigs.ARCH_IDS
    tcfg = tconfigs.get_arch(NAME, smoke=smoke)
    ta._same_config(jx, tcfg, jx.get_arch(NAME, smoke=smoke))
    assert tcfg.shapes() == jx.get_arch(NAME).shapes()
    for spec in tcfg.model.block_pattern:
        ttfm.check_ported(spec)


def test_full_width_parameter_count_without_allocating(jx):
    """2,894,528,000 parameters, leaf for leaf the JAX layout's shapes and
    dtypes: ``jax.eval_shape`` on one side, a meta-device init on the
    other."""
    jm = jx.get_arch(NAME).model
    jshapes = jx.jax.eval_shape(lambda k: jx.tfm.init_model(k, jm),
                                jx.jax.random.PRNGKey(0))
    tp = ttfm.init_model(0, tconfigs.get_arch(NAME).model, device="meta")
    n = 0
    for path, jl, tl in ta._walk(jshapes, tp):
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert str(tl.dtype).split(".")[-1] == jx.jnp.dtype(jl.dtype).name
        n += math.prod(jl.shape)
    assert n == ttfm.count_params(tp) == FULL_WIDTH_PARAMS
    assert n == jx.tfm.count_params(jshapes)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_forward_matches_jax(jx, dtype_name):
    jm, tm, jp, tp = ta._model(jx, NAME, dtype_name)
    ta._forward_case(jx, jm, tm, jp, tp, dtype_name,
                     ta._tokens(jm.vocab, (B, 40)))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("s,s0", [(40, 30), (24, 16)])
def test_prefill_and_decode_match_jax(jx, dtype_name, s, s0):
    """Logits and every cache leaf (the RG-LRU state and conv buffer, the
    local ring) after a prefill of ``s0`` tokens and each decode step."""
    jm, tm, jp, tp = ta._model(jx, NAME, dtype_name, seed=1)
    ta._serve_case(jx, jm, tm, jp, tp, dtype_name,
                   ta._tokens(jm.vocab, (B, s), seed=s), s0)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_generate_matches_jax(jx, dtype_name):
    jm, tm, jp, tp = ta._model(jx, NAME, dtype_name, seed=2)
    ta._generate_case(jx, jm, tm, jp, tp, dtype_name,
                      ta._tokens(jm.vocab, (B, 20), seed=2), n_new=8)


def test_prefill_cache_rounds_the_pre_conv_inputs():
    """At bf16 compute the prefill keeps the conv buffer in bf16, taken
    before the conv, and the state in f32 (the reference's layout)."""
    cfg = dataclasses.replace(tconfigs.get_arch(NAME, smoke=True).model,
                              dtype=torch.bfloat16, n_layers=1)
    params = ttfm.init_model(0, cfg, device="cpu")
    from repro_torch.serve import decode as tdec
    toks = torch.from_numpy(ta._tokens(cfg.vocab, (B, 9), seed=7))
    _, cache = tdec.prefill(params, cfg, {"tokens": toks}, 12)
    c = cache[0]["l0"]
    assert c["h"].dtype == torch.float32 and c["h"].shape == (B, 64)
    assert c["conv_buf"].dtype == torch.bfloat16
    p = params["stages"][0]["l0"]
    x = ttfm.embed_inputs(params, cfg, {"tokens": toks})
    xn = ttfm.layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
    main = ttfm.layers.matmul(xn, p["rglru"]["w_main"])
    assert torch.equal(c["conv_buf"], main[:, -3:].to(torch.bfloat16))


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_scan_on_the_card_matches_the_cpu(cuda):
    """recurrentgemma's width at T = 2048 (11 doubling steps), f32 with
    TF32 off, card against CPU. The doubling scan on the same (a, b): at
    ``TOL``. The gates: ``a`` within 4 f32 ulps of 1; ``b = sqrt(1 - a^2)
    * i * u`` is ill-conditioned where a is within ~1e-5 of 1 (one ulp of
    a moves ``1 - a^2`` by ~0.5%), so it is held at ``TOL`` to the CPU's
    ``i * u`` times ``sqrt(1 - a^2)`` of the card's own ``a``."""
    cfg = trg.RGLRUConfig(d_model=64, d_rnn=2560)
    p = trg.init_rglru_block(torch.Generator().manual_seed(0), cfg, "cpu")
    pc = {k: v.to(cuda) for k, v in p.items()}
    u = torch.from_numpy(_normal((2, 2048, 2560), 8))
    a, b = trg._gates(p, u)
    ac, bc = trg._gates(pc, u.to(cuda))
    ac, bc = ac.cpu(), bc.cpu()
    torch.testing.assert_close(ac, a, atol=4 * 2 ** -24, rtol=0)
    i = ttfm.layers.sigmoid(u @ p["w_x"] + p["b_x"])
    want_b = torch.sqrt(torch.clamp(1.0 - ac * ac, min=1e-12)) * (i * u)
    torch.testing.assert_close(bc, want_b, **TOL)
    _, h = trg.linear_scan(a, b)
    _, hc = trg.linear_scan(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(hc.cpu(), h, **TOL)
