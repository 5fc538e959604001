"""Port parity for the KAN-FFN LLM (``kan_llm``, ``kan_llm_int8``) and the
``lut_int8`` backend against the JAX package.

* ``lut_int8``: ``quantize_hemi`` bit for bit; given the same int8 basis
  codes the int32 accumulators bit for bit (an integer sum is exact);
  ``kan.apply`` within the ``lut`` bar ``atol 2e-5, rtol 1e-5`` (``tanh``
  in ``bound_input`` and the base branch's f32 product may differ by an
  ulp or sum in another order); its only contraction int8 x int8 -> int32.
* ``transformer.deploy_kan``: codes equal to JAX's, scales within one ulp
  (the f32 amax / 127 may round the other way), idempotent.
* The models, undeployed (the training path) and deployed on ``lut``,
  ``lut_int8`` and ``fused`` (the kernel's plain version on the CPU; JAX's
  Pallas kernel in interpret mode): forward, prefill + decode steps and
  generate at ``test_torch_lm.py``'s bars: ``2e-4`` at f32 with greedy
  tokens identical; at bf16 ``BF16_REL`` of the largest magnitude plus the
  reach of bf16 rounding (JAX's bf16 result against its f32 result, as in
  ``test_torch_attention.py``), greedy tokens equal up to the first near
  tie. One rule is added for the KAN-FFN: it quantises its inputs to 2^8
  levels, so an input an ulp from a level boundary, where the two packages
  differ by an ulp (XLA fuses the scanned layer body, the port does not),
  takes the neighbouring code. Every KAN layer's input codes are captured
  in both packages; where one differs, the logits and caches of that batch
  row from that position on are held to ``BF16_REL`` of their largest
  magnitude instead, and codes may differ in at most ``MAX_FLIP_SHARE`` of
  the inputs. Generate then keeps the near-tie rule at that bar.

``cuda``-marked cases import no JAX:
``python -m pytest -q -m cuda tests/test_torch_kan_llm.py``.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import kan as tk, quant as tq  # noqa: E402
from repro_torch.kernels import kan_fused as tkf  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

F32_BAR = 2e-4
BF16_REL = 2 ** -6
ATOL, RTOL = 2e-5, 1e-5           # the lut / fused kernel bar
MAX_FLIP_SHARE = 1e-3
B, S = 2, 24
KAN_LLMS = ["kan_llm", "kan_llm_int8"]
BACKENDS = ["lut", "lut_int8", "fused"]
# the KAN-LLM's kan_fused shapes (rows, I, O): prefill up and down over 16
# prompts of 512 tokens, a decode step's up and down over 16 rows
KAN_LLM_FUSED_SHAPES = [(8192, 256, 85), (8192, 85, 256), (16, 256, 85),
                        (16, 85, 256)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.core import kan, quant
    from repro.models import transformer
    from repro.serve import decode
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 kan=kan, quant=quant, tfm=transformer,
                                 dec=decode)


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


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _asp_pair(jx, **kw):
    return jx.quant.ASPConfig(**kw), tq.ASPConfig(**kw)


# --- lut_int8 ------------------------------------------------------------------

@pytest.mark.parametrize("g,k,n", [(8, 3, 8), (5, 3, 8), (7, 3, 8), (8, 2, 8),
                                   (3, 5, 8), (1, 3, 9)])
def test_quantize_hemi_bitwise_jax(jx, g, k, n):
    ja, ta = _asp_pair(jx, grid_size=g, order=k, n_bits=n)
    want = np.asarray(jx.quant.quantize_hemi(jx.quant.hemi_for(ja)))
    got = tq.quantize_hemi(tq.hemi_for(ta, "cpu"))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert tq.HEMI_LSB == jx.quant.HEMI_LSB


@pytest.mark.parametrize("m,ik,n", [(5, 935, 85), (16, 2816, 85),
                                    (40, 935, 256), (3, 64, 5)])
def test_lut_int8_accumulators_bitwise_jax(jx, m, ik, n):
    """The same int8 basis codes (taps in [0, 127]) and coefficient codes:
    the int32 accumulators equal JAX's ``dot_general`` bit for bit."""
    rng = np.random.default_rng(m + ik)
    e = rng.integers(0, 128, (m, ik)).astype(np.int8)
    e[rng.random((m, ik)) < 0.6] = 0                 # the basis is sparse
    c = rng.integers(-127, 128, (ik, n)).astype(np.int8)
    want = np.asarray(jx.jax.lax.dot_general(
        jx.jnp.asarray(e), jx.jnp.asarray(c), (((1,), (0,)), ((), ())),
        preferred_element_type=jx.jnp.int32))
    got = tk.int8_matmul(torch.from_numpy(e),
                         tk.int8_operand(torch.from_numpy(c)), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _kan_setup(jx, backend, b=64, i=32, o=24, base="relu", seed=0):
    """JAX params, both packages' artifacts (the port's deployed from the
    params carried across) and a numpy input."""
    ja, ta = _asp_pair(jx, grid_size=8)
    jspec = jx.kan.KANSpec.single(i, o, ja, backend=backend,
                                  base_activation=base)
    tspec = tk.KANSpec.single(i, o, ta, backend=backend, base_activation=base)
    jp = jx.kan.init(jx.jax.random.PRNGKey(seed), jspec)
    tp = tk.params_from_numpy(jx.jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).normal(size=(b, i)).astype(np.float32)
    return (jx.kan.deploy(jp, jspec), tk.deploy(tp, tspec), tp, tspec, x)


@pytest.mark.parametrize("base", ["relu", ""])
def test_lut_int8_apply_matches_jax(jx, base):
    jd, td, _, _, x = _kan_setup(jx, "lut_int8", base=base)
    (jl,), (tl,) = jd.layers, td.layers
    np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
    np.testing.assert_array_equal(tl.hemi_q.numpy(), np.asarray(jl.hemi_q))
    assert tl.hemi_q.dtype == torch.int8
    o = tl.codes.shape[-1]
    codes = tl.codes.reshape(-1, o)    # [I*S, O]
    ct = tl.codes_t                    # laid out once, at deploy time
    assert ct.dtype == torch.int8 and ct.shape == (
        -(-o // 8) * 8, -(-codes.shape[0] // 8) * 8) and ct.is_contiguous()
    assert torch.equal(ct[:o, :codes.shape[0]], codes.t())
    assert not ct[o:].any() and not ct[:, codes.shape[0]:].any()
    want = np.asarray(jx.kan.apply(jd, jx.jnp.asarray(x)))
    got = tk.apply(td, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_lut_int8_close_to_lut_and_trains(jx):
    """The twin of ``test_chip.py``'s case: basis-LSB error only against
    ``lut``, really quantised, and the training path's gradients finite."""
    _, td8, tp, tspec, x = _kan_setup(jx, "lut_int8")
    xt = torch.from_numpy(x)
    y8 = tk.apply(td8, xt)
    y = tk.apply(tk.deploy(tp, tspec.with_backend("lut")), xt)
    rel = float(torch.linalg.norm(y8 - y) / torch.linalg.norm(y))
    assert rel < 0.02, rel
    assert float((y8 - y).abs().max()) > 0
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    (tk.train_apply(params, xt, tspec, qat=True) ** 2).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) and bool(p.grad.any())
               for p in params.values())


class _Contractions(torch.overrides.TorchFunctionMode):
    """Records (name, operand dtypes, result dtype) of every product."""
    NAMES = ("matmul", "mm", "bmm", "einsum", "_int_mm", "__matmul__",
             "addmm", "tensordot", "linear")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if name in self.NAMES:
            self.seen.append((name, [a.dtype for a in args
                                     if isinstance(a, torch.Tensor)],
                              out.dtype))
        return out


def test_lut_int8_contraction_is_integer_end_to_end(jx):
    """The twin of ``test_chip.py``'s jaxpr pin: the spline's only product
    is int8 x int8 -> int32 (``torch._int_mm``), no f32 dequantisation
    before it."""
    _, td, _, _, x = _kan_setup(jx, "lut_int8", b=8, base="")
    with _Contractions() as rec:
        tk.apply(td, torch.from_numpy(x))
    assert rec.seen == [("_int_mm", [torch.int8, torch.int8], torch.int32)]


@contextlib.contextmanager
def _poisoned_quantisation(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("coefficient (re)quantisation while serving")
    with monkeypatch.context() as m:
        m.setattr(tq, "quantize_coeffs", boom)
        m.setattr(tq, "hemi_for", boom)
        m.setattr(tq, "quantize_hemi", boom)
        yield


@pytest.mark.parametrize("backend", BACKENDS)
def test_deployed_model_never_requantises(monkeypatch, backend):
    """deploy_kan freezes every artifact once; generate over the deployed
    model never reaches the coefficient or SH-LUT quantisation."""
    m = dataclasses.replace(tconfigs.get_arch("kan_llm", smoke=True).model,
                            kan_backend=backend)
    params = ttfm.deploy_kan(ttfm.init_model(0, m, device="cpu"), m)
    prompt = torch.from_numpy(_tokens(m.vocab, (B, 6)))
    with _poisoned_quantisation(monkeypatch):
        out = tdec.generate(params, m, prompt, n_new=4)
        with pytest.raises(AssertionError, match="quantisation while serving"):
            tk.apply_any(ttfm.init_model(1, m, device="cpu")["stages"][0]
                         ["l0"]["kan"], torch.zeros((1, m.d_model)),
                         m.kan_spec)
    assert out.shape == (B, 4)


# --- deploy_kan ------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_deploy_kan_matches_jax(jx, backend):
    """A stacked stage (2 repeats of one KAN block at SMOKE): codes,
    SH-LUTs and base weights equal to JAX's vmapped deploy, scales within
    one ulp; idempotent and the identity on models without KAN layers."""
    jm = dataclasses.replace(jx.get_arch("kan_llm", smoke=True).model,
                             kan_backend=backend)
    tm = dataclasses.replace(tconfigs.get_arch("kan_llm", smoke=True).model,
                             kan_backend=backend)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(0), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    jd, td = jx.tfm.deploy_kan(jp, jm), ttfm.deploy_kan(tp, tm)
    jart, tart = jd["stages"][0]["l0"]["kan"], td["stages"][0]["l0"]["kan"]
    assert isinstance(tart, tk.DeployedKAN) and tart.spec == tm.kan_spec
    for jl, tl in zip(jart.layers, tart.layers):
        for f in ("codes", "hemi", "hemi_q", "w_base"):
            a, b = getattr(jl, f), getattr(tl, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert tuple(b.shape) == tuple(a.shape), f
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        js, ts = np.asarray(jl.scale), tl.scale.numpy()
        assert ts.shape == js.shape and ts.dtype == js.dtype
        np.testing.assert_array_max_ulp(ts, js, maxulp=1)
        assert tl.codes[1].is_contiguous()
    assert ttfm.deploy_kan(td, tm) is td
    # the port's lut_int8 artifact adds the codes laid out for _int_mm
    laid_out = sum(l.codes_t.numel() for st in td["stages"]
                   for blk in st.values() if "kan" in blk
                   for l in blk["kan"].layers if l.codes_t is not None)
    assert (laid_out > 0) == (backend == "lut_int8")
    assert ttfm.count_params(td) - laid_out == jx.tfm.count_params(jd)
    dense = tconfigs.get_arch("mistral_nemo_12b", smoke=True).model
    p = ttfm.init_model(0, dense, device="cpu")
    assert ttfm.deploy_kan(p, dense) is p


def test_tree_utilities_walk_deployed_artifacts():
    m = tconfigs.get_arch("kan_llm_int8", smoke=True).model
    dep = ttfm.deploy_kan(ttfm.init_model(0, m, device="cpu"), m)
    art = dep["stages"][0]["l0"]["kan"]
    one = ttfm.layer_of(dep["stages"][0], 1)["l0"]["kan"]
    assert isinstance(one, tk.DeployedKAN) and one.spec is art.spec
    assert one.layers[0].atten is None
    assert torch.equal(one.layers[0].codes, art.layers[0].codes[1])
    assert one.layers[0].codes.is_contiguous()
    moved = ttfm.tree_map(lambda t: t.to(torch.float64) if t.is_floating_point()
                          else t, dep)
    assert moved["stages"][0]["l0"]["kan"].layers[1].scale.dtype == \
        torch.float64
    again = ttfm.tree_stack([ttfm.layer_of(dep["stages"][0], r)
                             for r in range(m.n_layers)])
    for a, b in zip(ttfm.tree_leaves(again), ttfm.tree_leaves(
            dep["stages"][0])):
        assert torch.equal(a, b)


# --- the models against JAX ------------------------------------------------------

class _Codes:
    """Every KAN layer's input codes in both packages, captured where each
    bounds its input (JAX through a debug callback, so inside its scanned
    and rematerialised layer body too)."""

    def __init__(self, jx, monkeypatch):
        self.jx, self.j, self.t = jx, [], []
        jbound, tbound = jx.kan.bound_input, tk.bound_input

        def jhook(x, asp):
            xb = jbound(x, asp)
            jx.jax.debug.callback(
                lambda a, asp=asp: self.j.append(np.asarray(
                    jx.quant.quantize_input(jx.jnp.asarray(a), asp))), xb)
            return xb

        def thook(x, asp):
            xb = tbound(x, asp)
            self.t.append(tq.quantize_input(xb, asp).numpy())
            return xb
        monkeypatch.setattr(jx.kan, "bound_input", jhook)
        monkeypatch.setattr(tk, "bound_input", thook)

    def clear(self):
        self.j, self.t = [], []

    def take(self):
        """[{(b, s) of a differing code}] per KAN layer call since the last
        take or clear, and the number of codes compared."""
        assert self.j and len(self.j) == len(self.t), (len(self.j),
                                                       len(self.t))
        pairs = list(zip(self.j, self.t))
        self.clear()
        flips, n = [], 0
        for a, b in pairs:
            assert a.shape == b.shape, (a.shape, b.shape)
            n += a.size
            flips.append({(int(i), int(j)) for i, j in
                          np.argwhere(a != b)[:, :2]})
        return flips, n


def _flip_share(flips, n, dtype_name):
    """``flips``: the differing (b, s) of each KAN layer call in order, s the
    token's position. A code that differs downstream of an earlier one (the
    same row, a position at or after it) follows from it; the others are
    the ulp-level events, and at f32 they must stay under MAX_FLIP_SHARE of
    the ``n`` codes. At bf16 the inputs differ by bf16 steps, 2^-8 of their
    size and near the quantisation step itself, so codes differ often and
    only the bf16 bar applies."""
    first, roots = [None] * B, 0
    for f in flips:
        roots += sum(1 for b, p in f if first[b] is None or p < first[b])
        first = _first_flip([f, {(b, q) for b, q in enumerate(first)
                                 if q is not None}], B)
    if dtype_name == "f32":
        assert roots <= MAX_FLIP_SHARE * n, (roots, flips)


def _first_flip(flips, n_rows):
    """Per batch row, the first position whose codes differed (or None)."""
    first = [None] * n_rows
    for f in flips:
        for b, s in f:
            first[b] = s if first[b] is None else min(first[b], s)
    return first


def _hold(got, want, dtype_name, what, want_f32=None, loose=None):
    """``got`` (port) against ``want`` (JAX, numpy f32; leading axis the
    batch row). ``loose`` [B, ...] marks the entries downstream of a
    differing input code, held to ``BF16_REL`` of the largest magnitude."""
    got = _tn(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    if dtype_name == "bf16":
        bar = (BF16_REL * float(np.abs(want).max())
               + float(np.abs(want - want_f32).max()))
        assert float(err.max()) <= bar, (what, float(err.max()), bar)
        return
    if loose is not None and loose.any():
        mask = np.broadcast_to(loose.reshape(loose.shape + (1,) * (
            err.ndim - loose.ndim)), err.shape)
        flip_bar = BF16_REL * float(np.abs(want).max())
        assert float(err[mask].max()) <= flip_bar, (what, "flipped",
                                                   float(err[mask].max()))
        err = np.where(mask, 0.0, err)
    assert float(err.max()) <= F32_BAR, (what, float(err.max()))


def _positions_after(first, n_rows, positions):
    """[B, len(positions)] bool: position at or after the row's first
    differing code."""
    pos = np.asarray(positions)
    return np.stack([pos >= f if f is not None else np.zeros(len(pos), bool)
                     for f in first[:n_rows]])


def _model(jx, name, dtype_name, seed, backend=None):
    jdt, tdt = _dtypes(jx, dtype_name)
    over = {} if backend is None else {"kan_backend": backend}
    jm = dataclasses.replace(jx.get_arch(name, smoke=True).model, dtype=jdt,
                             **over)
    tm = dataclasses.replace(tconfigs.get_arch(name, smoke=True).model,
                             dtype=tdt, **over)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    if backend is not None:
        jp, tp = jx.tfm.deploy_kan(jp, jm), ttfm.deploy_kan(tp, tm)
    return jm, tm, jp, tp


def _f32(jx, jm):
    return dataclasses.replace(jm, dtype=jx.jnp.float32)


def _forward_case(jx, codes, jm, tm, jp, tp, dtype_name, toks):
    want = _np(jx, jx.tfm.forward(jp, jm, {"tokens": jx.jnp.asarray(toks)}
                                  )[0])
    got, _ = ttfm.forward(tp, tm, {"tokens": torch.from_numpy(toks)})
    flips, n = codes.take()
    want32 = None
    if dtype_name == "bf16":
        want32 = _np(jx, jx.tfm.forward(jp, _f32(jx, jm), {
            "tokens": jx.jnp.asarray(toks)})[0])
        codes.clear()
    _flip_share(flips, n, dtype_name)
    loose = _positions_after(_first_flip(flips, B), B, range(toks.shape[1]))
    _hold(got, want, dtype_name, "forward logits", want32, loose)


def _serve(dec, tfm_params, cfg, toks, s0, jnp=None):
    """prefill over ``toks[:, :s0]`` and the decode steps over the rest:
    [(logits, cache)] per step (``jnp`` for JAX's arrays)."""
    wrap = jnp.asarray if jnp is not None else torch.from_numpy
    lg, c = dec.prefill(tfm_params, cfg, {"tokens": wrap(toks[:, :s0])},
                        max_len=toks.shape[1])
    out = [(lg, c)]
    for i in range(s0, toks.shape[1]):
        lg, c = dec.decode_step(tfm_params, c, wrap(toks[:, i:i + 1]), i, cfg)
        out.append((lg, c))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _serve_case(jx, codes, jm, tm, jp, tp, dtype_name, toks, s0):
    """Logits and cache leaves after prefill and each decode step."""
    n_dec = toks.shape[1] - s0
    want = _serve(jx.dec, jp, jm, toks, s0, jx.jnp)
    got = _serve(tdec, tp, tm, toks, s0)
    flips, n = codes.take()
    want32 = None
    if dtype_name == "bf16":
        want32 = _serve(jx.dec, jp, _f32(jx, jm), toks, s0, jx.jnp)
        codes.clear()
    # step 0 is the prefill (positions 0..s0-1); step k the decode of
    # position s0 + k - 1, whose captures hold it at index 0
    n_kan = len(flips) // (1 + n_dec)
    flips = [{(b, p + (0 if c < n_kan else s0 + c // n_kan - 1))
              for b, p in f} for c, f in enumerate(flips)]
    _flip_share(flips, n, dtype_name)
    first = [None] * B
    for step, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        offset = 0 if step == 0 else s0 + step - 1
        first = _first_flip(flips[n_kan * step:n_kan * (step + 1)] + [
            {(b, f) for b, f in enumerate(first) if f is not None}], B)
        positions = range(s0) if step == 0 else [offset]
        loose = _positions_after(first, B, positions)
        row_loose = np.array([f is not None for f in first])
        jl32, jc32 = (None, None) if want32 is None else want32[step]
        _hold(tl, _np(jx, jl), dtype_name, ("logits", step),
              None if jl32 is None else _np(jx, jl32), loose)
        jleaves, tleaves = _leaves(jc), ttfm.tree_leaves(tc)
        j32 = None if jc32 is None else _leaves(jc32)
        assert len(jleaves) == len(tleaves)
        for k, (a, b) in enumerate(zip(jleaves, tleaves)):
            a = _np(jx, a)
            # a stacked stage's K/V lead with the layer axis: [R, B, T, ...]
            lo = (np.broadcast_to(row_loose[None], a.shape[:2])
                  if a.ndim == 5 else row_loose)
            _hold(b, a, dtype_name, (step, k),
                  None if j32 is None else _np(jx, j32[k]), lo)


def _generate_case(jx, codes, jm, tm, jp, tp, dtype_name, prompt, n_new=6):
    want = np.asarray(jx.dec.generate(jp, jm, jx.jnp.asarray(prompt),
                                      n_new=n_new))
    got = tdec.generate(tp, tm, torch.from_numpy(prompt), n_new=n_new
                        ).numpy()
    flips, _ = codes.take()
    assert got.shape == want.shape == (prompt.shape[0], n_new)
    if dtype_name == "f32" and not any(flips):
        np.testing.assert_array_equal(got, want)
        return
    steps = _serve(jx.dec, jp, jm, np.concatenate([prompt, want[:, :-1]], 1),
                   prompt.shape[1], jx.jnp)
    codes.clear()
    lead_until = len(steps)
    for i, (lg, _) in enumerate(steps):
        lg = _np(jx, lg)[:, -1]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] <= BF16_REL * 8):
            lead_until = i
            break
    np.testing.assert_array_equal(got[:, :lead_until], want[:, :lead_until])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", KAN_LLMS)
def test_forward_matches_jax(jx, monkeypatch, name, dtype_name):
    codes = _Codes(jx, monkeypatch)
    jm, tm, jp, tp = _model(jx, name, dtype_name, seed=0)
    _forward_case(jx, codes, jm, tm, jp, tp, dtype_name,
                  _tokens(jm.vocab, (B, S)))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", KAN_LLMS)
def test_prefill_and_decode_match_jax(jx, monkeypatch, name, dtype_name):
    codes = _Codes(jx, monkeypatch)
    jm, tm, jp, tp = _model(jx, name, dtype_name, seed=1)
    _serve_case(jx, codes, jm, tm, jp, tp, dtype_name,
                _tokens(jm.vocab, (B, S), seed=1), S - 6)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", KAN_LLMS)
def test_generate_matches_jax(jx, monkeypatch, name, dtype_name):
    codes = _Codes(jx, monkeypatch)
    jm, tm, jp, tp = _model(jx, name, dtype_name, seed=2)
    _generate_case(jx, codes, jm, tm, jp, tp, dtype_name,
                   _tokens(jm.vocab, (B, 8), seed=2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_deployed_model_matches_jax(jx, monkeypatch, backend):
    """kan_llm deployed by both packages (``deploy_kan``) on each backend:
    forward, prefill + decode and generate at f32."""
    codes = _Codes(jx, monkeypatch)
    jm, tm, jp, tp = _model(jx, "kan_llm", "f32", seed=3, backend=backend)
    toks = _tokens(jm.vocab, (B, S), seed=3)
    _forward_case(jx, codes, jm, tm, jp, tp, "f32", toks)
    _serve_case(jx, codes, jm, tm, jp, tp, "f32", toks, S - 4)
    _generate_case(jx, codes, jm, tm, jp, tp, "f32", toks[:, :8])


# --- on the card -------------------------------------------------------------------

def _kan_llm_layer(shape, seed=0):
    """A deployed KAN layer of the KAN-LLM's FFN (G=8, K=3) at (rows, I, O)
    and a bounded input: the artifact comes from the port's own deploy."""
    b, i, o = shape
    asp = tq.ASPConfig(grid_size=8, order=3)
    spec = tk.KANSpec.single(i, o, asp, base_activation="")
    gen = torch.Generator().manual_seed(seed)
    dep = tk.deploy(tk.init(gen, spec, device="cpu"), spec)
    x = tk.bound_input(torch.randn((b, i), generator=gen), asp)
    return dep.layers[0], asp, x


def test_kan_fused_takes_the_kan_llm_config():
    """G = 8, K = 3 (S = 11, L = 32): the kernel's tap table fits."""
    assert tkf.supported(tq.ASPConfig(grid_size=8, order=3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KAN_LLM_FUSED_SHAPES)
def test_kan_fused_at_the_kan_llm_shapes(cuda, shape):
    """The kernel against the plain formula in float64 at the kernel
    tests' bar, and bitwise equal to itself on a second launch."""
    layer, asp, x = _kan_llm_layer(shape)
    codes, scale, hemi = (layer.codes.to(cuda), layer.scale.reshape(-1)
                          .to(cuda), layer.hemi.to(cuda))
    got = tops.kan_spline_fused_deployed(x.to(cuda), codes, scale, asp,
                                         hemi=hemi)
    again = tops.kan_spline_fused_deployed(x.to(cuda), codes, scale, asp,
                                           hemi=hemi)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    e = tq.quantized_basis(x, layer.hemi, asp).reshape(x.shape[0], -1)
    exact = (e.double() @ layer.codes.double().reshape(e.shape[1], -1)
             ) * layer.scale.reshape(-1).double()
    torch.testing.assert_close(got.cpu().double(), exact, atol=ATOL,
                               rtol=RTOL)
    plain = tref.kan_spline_ref(x, layer.codes, layer.scale.reshape(-1), asp,
                                layer.hemi)
    torch.testing.assert_close(plain.double(), exact, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 256, 85), (16, 256, 85),
                                   (8192, 85, 256), (16, 85, 256)])
def test_lut_int8_on_the_card_equals_the_cpu(cuda, shape):
    """The int32 accumulators and the rescaled f32 outputs of one artifact
    on one bounded input are bitwise the same on the card (``_int_mm``,
    operands padded) and on the CPU."""
    layer, asp, x = _kan_llm_layer(shape, seed=1)
    layer = dataclasses.replace(
        layer, hemi_q=tq.quantize_hemi(layer.hemi),
        codes_t=tk.int8_operand(layer.codes.reshape(-1, shape[2])))
    spec = tk.KANSpec.single(shape[1], shape[2], asp, backend="lut_int8",
                             base_activation="", bound_input=False)
    on_card = dataclasses.replace(layer, **{
        f.name: getattr(layer, f.name).to(cuda)
        for f in dataclasses.fields(layer)
        if getattr(layer, f.name) is not None})
    e = tq.quantized_basis(x, layer.hemi_q, asp).reshape(x.shape[0], -1)
    c = layer.codes_t
    acc_cpu = tk.int8_matmul(e, c, shape[2])
    acc_card = tk.int8_matmul(e.to(cuda), c.to(cuda), shape[2])
    y_cpu = tk.apply(tk.DeployedKAN((layer,), spec), x)
    y_card = tk.apply(tk.DeployedKAN((on_card,), spec), x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(acc_card.cpu(), acc_cpu)
    assert torch.equal(y_card.cpu(), y_cpu)
