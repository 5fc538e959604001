"""Port parity for the continuous-batching engine
(``repro_torch.serve.engine``) and the paged half of ``serve/decode.py``
against the JAX package, and the engine's own contracts.

* The same params (JAX's, carried across with ``params_from_numpy``) and
  the same ``synth_trace`` go through JAX's ``Engine`` and the port's, on
  the SMOKE configs of ``kan_llm`` (``lut``, ``fused``; the engines deploy
  their own artifacts), ``mistral_nemo_12b``, ``mamba2_1p3b`` and
  ``recurrentgemma_2b``: at f32 every completion is token-identical (and
  its stop reason, slot and ticks equal), and the ``EngineStats`` counters
  are equal (ticks, slot reuse, peak pages in use, prefix hits, chunks,
  evictions by reason). At bf16 tokens are equal up to the first step where
  JAX's top-1 logit leads its top-2 by no more than ``BF16_REL * 8``
  (``test_torch_attention.py``'s bar), teacher-forced on JAX's own tokens
  through a solo run.
* The paged helpers (``attention.paged_*``) give JAX's pools bit for bit;
  ``prefill_chunk`` and ``decode_step(pages=)`` give JAX's logits and
  caches at the f32 bar ``2e-4`` (``test_torch_lm.py``'s).
* ``tests/test_engine.py``'s cases (batching invariance against solo runs,
  EOS eviction, backpressure, over-length, priority, ``generate`` with a
  list of prompts) and ``tests/test_paged_cache.py``'s engine cases
  (multi-chunk invariance, the prefix refcount, SSD never sharing, a long
  prefill not stalling short requests) run on the port.

``cuda``-marked cases import no JAX: ``python -m pytest -q -m cuda
tests/test_torch_engine.py``. They hold ``kan_fused`` at the engine's tick
and chunk shapes and ``ssd_scan`` on its ``init_state`` path at the
chunk's shape against their plain versions, and the engine on the card
against the engine on the CPU.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import kan as tk, quant as tq  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.scheduler import (AdmissionQueue,  # noqa: E402
                                         Request)
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

F32_BAR = 2e-4
BF16_REL = 2 ** -6
LEAD_BAR = BF16_REL * 8
ATOL, RTOL = 2e-5, 1e-5           # the kan_fused kernel tests' bar
SSD_ATOL, SSD_RTOL = 3e-5, 1e-4   # the ssd kernel tests' bar
# (arch, kan backend): the five smoke configs the engine serves
PARITY = [("mamba2_1p3b", None), ("mistral_nemo_12b", None),
          ("recurrentgemma_2b", None), ("kan_llm", "lut"),
          ("kan_llm", "fused")]
STAT_COUNTERS = ("ticks", "idle_ticks", "ff_ticks", "prefills",
                 "decode_tokens", "completed", "evicted_eos",
                 "evicted_length", "rejected", "occupancy_ticks",
                 "slot_served", "pages_in_use_peak", "prefill_chunks",
                 "prefix_hit_pages", "prefix_eligible_pages")
# the engine's kan_fused shapes on kan_llm (rows, I, O): the fused tick at
# 16 slots, up and down, and a 64-token prefill chunk, up and down
TICK_SHAPES = [(16, 256, 85), (16, 85, 256), (64, 256, 85), (64, 85, 256)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import attention, transformer
    from repro.serve import decode, engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 attn=attention, tfm=transformer, dec=decode,
                                 eng=engine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np(jx, a):
    return np.asarray(jx.jnp.asarray(a).astype(jx.jnp.float32))


def _tn(t):
    return t.detach().float().cpu().numpy()


def _model(jx, name, dtype_name="f32", backend=None, seed=0):
    jdt, tdt = {"f32": (jx.jnp.float32, torch.float32),
                "bf16": (jx.jnp.bfloat16, torch.bfloat16)}[dtype_name]
    over = {} if backend is None else {"kan_backend": backend}
    jm = dataclasses.replace(jx.get_arch(name, smoke=True).model, dtype=jdt,
                             **over)
    tm = dataclasses.replace(tconfigs.get_arch(name, smoke=True).model,
                             dtype=tdt, **over)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


def _port_model(name, seed=0):
    """Port-only cases: the port's own seeded init on the CPU."""
    m = tconfigs.get_arch(name, smoke=True).model
    return m, ttfm.init_model(seed, m, device="cpu")


def _solo_greedy(params, m, prompt, n_new, max_len):
    """The request alone through the port's static-batch path."""
    logits, cache = tdec.prefill(params, m,
                                 {"tokens": torch.as_tensor(prompt)[None]},
                                 max_len=max_len, last_only=True)
    tok = int(torch.argmax(logits[0, -1]))
    out, i = [tok], len(prompt)
    for _ in range(n_new - 1):
        lg, cache = tdec.decode_step(params, cache, torch.tensor([[tok]]), i,
                                     m)
        tok = int(torch.argmax(lg[0, -1]))
        out.append(tok)
        i += 1
    return out


def _engine(params, m, **kw):
    return teng.Engine(params, m, device="cpu", **kw)


def _counters(stats):
    return {k: getattr(stats, k) for k in STAT_COUNTERS}


def _comps(comps):
    return {c.rid: ([int(t) for t in c.tokens], c.reason, c.slot,
                    c.admitted_tick, c.finished_tick) for c in comps}


def _first_step_without_lead(jx, jp, jm, prompt, toks, bar):
    """The first generated step where JAX's solo top-1 logit leads its
    top-2 by no more than ``bar``, teacher-forced on ``toks``."""
    logits, cache = jx.dec.prefill(jp, jm, {"tokens": prompt[None]},
                                   len(prompt) + len(toks), last_only=True)
    steps = [logits[0, -1]]
    for i in range(len(toks) - 1):
        logits, cache = jx.dec.decode_step(
            jp, cache, jx.jnp.asarray([[toks[i]]]), len(prompt) + i, jm)
        steps.append(logits[0, 0])
    for i, lg in enumerate(steps):
        top2 = np.sort(_np(jx, lg))[-2:]
        if top2[1] - top2[0] <= bar:
            return i
    return len(steps)


def _run_both(jx, jm, tm, jp, tp, trace_kw, **eng_kw):
    reqs = dict(jax=jx.eng.synth_trace(jm.vocab, **trace_kw),
                port=teng.synth_trace(tm.vocab, **trace_kw))
    for a, b in zip(reqs["jax"], reqs["port"]):
        assert np.array_equal(np.asarray(a.tokens), b.tokens)
        assert (a.max_new, a.priority, a.arrival) == (
            b.max_new, b.priority, b.arrival)
    je = jx.eng.Engine(jp, jm, **eng_kw)
    te = _engine(tp, tm, **eng_kw)
    return (je, je.run(reqs["jax"])), (te, te.run(reqs["port"])), reqs["jax"]


TRACE = dict(n_requests=6, max_prompt=13, min_prompt=4, max_new=7,
             min_new=3, stagger=2, seed=1)


@pytest.mark.parametrize("page_size", [4, None])
@pytest.mark.parametrize("name,backend", PARITY)
def test_engine_matches_jax(jx, name, backend, page_size):
    """Two slots over six staggered requests (slot reuse, chunked prefill
    across pages at page size 4, one page a slot at the default): the
    port's completions and counters are JAX's."""
    jm, tm, jp, tp = _model(jx, name, backend=backend)
    (je, jc), (te, tc), _ = _run_both(jx, jm, tm, jp, tp, TRACE, n_slots=2,
                                      max_len=24, page_size=page_size)
    assert te.kan_deployed == je.kan_deployed == (backend is not None)
    assert te.chunk_tokens == je.chunk_tokens
    assert te.share_ok == je.share_ok
    assert _comps(tc) == _comps(jc)
    assert _counters(te.stats) == _counters(je.stats)
    assert te.stats.report()["slot_reuse"] > 1
    assert te.alloc.in_use == 0
    te.alloc.check()


@pytest.mark.parametrize("name,backend", [("mistral_nemo_12b", None),
                                          ("kan_llm", "fused")])
def test_engine_prefix_sharing_matches_jax(jx, name, backend):
    """A shared 8-token prefix at page size 4: later prompts share the
    first requests' pages, in both packages alike."""
    jm, tm, jp, tp = _model(jx, name, backend=backend, seed=1)
    trace = dict(TRACE, n_requests=5, common_prefix=8, stagger=3)
    (je, jc), (te, tc), _ = _run_both(jx, jm, tm, jp, tp, trace, n_slots=3,
                                      max_len=32, page_size=4)
    assert _comps(tc) == _comps(jc)
    assert _counters(te.stats) == _counters(je.stats)
    assert te.stats.prefix_hit_pages > 0


@pytest.mark.parametrize("name", ["mamba2_1p3b", "mistral_nemo_12b"])
def test_engine_matches_jax_at_bf16(jx, name):
    """bf16 compute: tokens equal up to the first near tie."""
    jm, tm, jp, tp = _model(jx, name, "bf16", seed=2)
    (je, jc), (te, tc), reqs = _run_both(jx, jm, tm, jp, tp, TRACE,
                                         n_slots=2, max_len=24, page_size=4)
    got, want = _comps(tc), _comps(jc)
    assert set(got) == set(want)
    compared = 0
    for rid, (toks, *_) in want.items():
        prompt = jx.jnp.asarray(np.asarray(reqs[rid].tokens))
        cut = _first_step_without_lead(jx, jp, jm, prompt, toks, LEAD_BAR)
        assert got[rid][0][:cut] == toks[:cut], (rid, cut)
        assert len(got[rid][0]) == len(toks)
        compared += cut
    assert compared > 0


# --- the paged functions ---------------------------------------------------------

def test_paged_helpers_match_jax(jx):
    """Gather, the decode write (inactive slots all on the garbage page)
    and the prefill write, bit for bit; the port writes in place."""
    rng = np.random.default_rng(0)
    n_pages, ps, kv, hd = 9, 4, 2, 8
    pool = rng.normal(size=(n_pages, ps, kv, hd)).astype(np.float32)
    pages = np.array([[3, 5, 0], [0, 0, 0], [7, 1, 2], [0, 0, 0]], np.int32)
    index = np.array([6, 0, 9, 0], np.int32)
    kn, vn = (rng.normal(size=(4, 1, kv, hd)).astype(np.float32)
              for _ in range(2))
    tpages, tindex = (torch.from_numpy(a.astype(np.int64))
                      for a in (pages, index))
    got = tattn.paged_gather(torch.from_numpy(pool), tpages)
    want = jx.attn.paged_gather(jx.jnp.asarray(pool), jx.jnp.asarray(pages))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jk, jv = jx.attn.paged_cache_update(
        *(jx.jnp.asarray(a) for a in (pool, pool, kn, vn, pages, index)))
    tk_, tv_ = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    tattn.paged_cache_update(tk_, tv_, torch.from_numpy(kn),
                             torch.from_numpy(vn), tpages, tindex)
    # page 0 takes colliding garbage writes: which one lands is unspecified
    np.testing.assert_array_equal(tk_.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv_.numpy()[1:], np.asarray(jv)[1:])
    for start, length in ((0, 7), (4, 4), (8, 3)):
        row = np.array([6, 2, 8], np.int32)
        kc = rng.normal(size=(1, length, kv, hd)).astype(np.float32)
        jk, jv = jx.attn.paged_prefill_update(
            *(jx.jnp.asarray(a) for a in (pool, pool, kc, kc, row)),
            jx.jnp.asarray(start, jx.jnp.int32))
        tkp, tvp = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
        tattn.paged_prefill_update(tkp, tvp, torch.from_numpy(kc),
                                   torch.from_numpy(kc),
                                   torch.from_numpy(row.astype(np.int64)),
                                   start)
        np.testing.assert_array_equal(tkp.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tvp.numpy(), np.asarray(jv))


def _keyed_leaves(jtree, ttree, key=None):
    """(dict key, JAX leaf, port leaf) over two cache trees of one layout."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            yield from _keyed_leaves(jtree[k], ttree[k], k)
    elif isinstance(jtree, (list, tuple)):
        for a, b in zip(jtree, ttree, strict=True):
            yield from _keyed_leaves(a, b, key)
    else:
        yield key, jtree, ttree


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "mamba2_1p3b"])
def test_prefill_chunk_and_paged_decode_match_jax(jx, name):
    """Three chunks of a 24-token prompt into slot 1 of two (page size 8,
    so attention reads earlier pages and SSD carries its state), then two
    fused ticks with slot 0 inactive: logits at the f32 bar, every cache
    leaf too (the garbage page and inactive rows aside)."""
    jm, tm, jp, tp = _model(jx, name, seed=3)
    n_slots, max_len, ps = 2, 32, 8
    chunk = tdec.chunk_tokens_for(tm, ps)
    assert chunk == jx.dec.chunk_tokens_for(jm, ps)
    n_pages = n_slots * (max_len // ps) + 1
    jc = jx.dec.init_paged_cache(jm, n_slots, max_len, page_size=ps,
                                 n_pages=n_pages)
    tc = tdec.init_paged_cache(tm, n_slots, max_len, page_size=ps,
                               n_pages=n_pages, device="cpu")
    row = np.array([3, 4, 5, 6], np.int32)
    prompt = np.random.default_rng(3).integers(1, tm.vocab, 24
                                               ).astype(np.int32)
    starts = list(range(0, len(prompt), chunk))
    for start in starts:
        toks = prompt[start:start + chunk][None]
        first, last = start == 0, start + chunk >= len(prompt)
        jt, jc = jx.dec.prefill_chunk(
            jp, jm, jc, jx.jnp.asarray(toks), jx.jnp.asarray(start),
            jx.jnp.asarray(1), jx.jnp.asarray(row), first=first, last=last)
        tt, tc2 = tdec.prefill_chunk(tp, tm, tc, torch.from_numpy(toks),
                                     start, 1, torch.from_numpy(
                                         row.astype(np.int64)),
                                     first=first, last=last)
        assert tc2 is tc            # written in place
        if last:
            assert int(tt[0]) == int(np.asarray(jt)[0])
    tok = int(np.asarray(jt)[0])
    pages = np.zeros((n_slots, max_len // ps), np.int32)
    pages[1] = row
    for i in range(2):
        index = np.array([0, len(prompt) + i], np.int32)
        toks = np.array([[0], [tok]], np.int32)
        jl, jc = jx.dec.decode_step(jp, jc, jx.jnp.asarray(toks),
                                    jx.jnp.asarray(index), jm,
                                    pages=jx.jnp.asarray(pages))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(index.astype(np.int64)),
                                  tm, pages=torch.from_numpy(
                                      pages.astype(np.int64)))
        err = float(np.abs(_tn(tl[1]) - _np(jx, jl[1])).max())
        assert err <= F32_BAR, (i, err)
        tok = int(np.argmax(_np(jx, jl[1, -1])))
        assert int(torch.argmax(tl[1, -1])) == tok
    for key, j, t in _keyed_leaves(jc, tc):
        j, t = _np(jx, j), _tn(t)
        assert j.shape == t.shape, key
        if key in ("k", "v"):         # a page pool: page 0 takes garbage
            j, t = (np.take(a, range(1, a.shape[-4]), axis=a.ndim - 4)
                    for a in (j, t))
        assert float(np.abs(j - t).max()) <= F32_BAR, key


def test_chunked_ssd_state_equals_solo_prefill():
    """The state a slot carries out of three chunks (the kernel's
    init_state path on the card) is a solo whole-prompt prefill's, and the
    next token the same."""
    m, params = _port_model("mamba2_1p3b", seed=4)
    ps = 4
    chunk = tdec.chunk_tokens_for(m, ps)
    assert chunk == m.ssm_chunk == 16
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        1, m.vocab, 40))
    cache = tdec.init_paged_cache(m, 2, 48, page_size=ps, n_pages=25,
                                  device="cpu")
    row = torch.arange(1, 13)
    for start in range(0, 40, chunk):
        tok, cache = tdec.prefill_chunk(
            params, m, cache, prompt[start:start + chunk][None], start, 1,
            row, first=start == 0, last=start + chunk >= 40)
    logits, solo = tdec.prefill(params, m, {"tokens": prompt[None]}, 48,
                                last_only=True)
    assert int(tok[0]) == int(torch.argmax(logits[0, -1]))
    got, want = cache[0]["l0"], solo[0]["l0"]
    torch.testing.assert_close(got["state"][:, 1], want["state"][:, 0],
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got["conv_buf"][:, 1], want["conv_buf"][:, 0])
    assert not got["state"][:, 0].any()       # the other slot untouched


# --- tests/test_engine.py on the port --------------------------------------------

@pytest.mark.parametrize("arch_id", ["mistral_nemo_12b", "mamba2_1p3b",
                                     "recurrentgemma_2b"])
def test_batching_invariance_staggered_trace(arch_id):
    m, params = _port_model(arch_id)
    max_len = 20
    reqs = teng.synth_trace(m.vocab, 6, max_prompt=10, min_prompt=4,
                            max_new=7, min_new=3, stagger=2, seed=1)
    eng = _engine(params, m, n_slots=2, max_len=max_len)
    comps = eng.run(reqs)
    assert len(comps) == len(reqs)
    for c in comps:
        r = reqs[c.rid]
        ref = _solo_greedy(params, m, r.tokens, r.max_new, max_len)
        assert list(c.tokens) == ref, (c.rid, list(c.tokens), ref)
        assert len(c.tokens) == r.max_new
    assert max(eng.stats.slot_served) > 1
    assert sum(eng.stats.slot_served) == len(reqs)
    assert eng.stats.completed == len(reqs)
    assert 0.0 < eng.stats.mean_occupancy() <= 1.0


def test_eos_eviction_frees_slot_and_readmits():
    m, params = _port_model("mamba2_1p3b")
    max_len = 16
    prompt = np.arange(1, 7) % m.vocab
    ref = _solo_greedy(params, m, prompt, 6, max_len)
    eos = ref[1]
    eng = _engine(params, m, n_slots=1, max_len=max_len)
    reqs = [Request(rid="stopper", tokens=prompt, max_new=6, eos_id=eos),
            Request(rid="follower", tokens=(np.arange(3, 11) % m.vocab),
                    max_new=4)]
    by_rid = {c.rid: c for c in eng.run(reqs)}
    assert by_rid["stopper"].reason == "eos"
    assert list(by_rid["stopper"].tokens) == ref[:2]
    assert by_rid["follower"].reason == "length"
    assert len(by_rid["follower"].tokens) == 4
    assert eng.stats.slot_served == [2]
    assert eng.stats.evicted_eos == 1 and eng.stats.evicted_length == 1
    assert not eng.active.any()


def test_queue_overflow_backpressure():
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=1, max_len=16,
                  queue=AdmissionQueue(max_pending=2))

    def mk(i, arr):
        return Request(rid=i, tokens=np.arange(4) % m.vocab, max_new=3,
                       arrival=arr)
    assert eng.submit(mk(0, 100)) and eng.submit(mk(1, 100))
    assert not eng.submit(mk(2, 100))
    assert eng.stats.rejected == 1
    assert len(eng.queue) == 2
    comps = eng.run([mk(3, 0), mk(4, 0)])
    assert {c.rid for c in comps} == {0, 1, 3, 4}
    assert eng.stats.completed == 4
    assert eng.stats.rejected == 1


def test_over_length_request_rejected_loudly():
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=1, max_len=8)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        eng.submit(Request(rid=0, tokens=np.arange(6), max_new=6))
    with pytest.raises(ValueError, match="max_new must be >= 1"):
        eng.submit(Request(rid=1, tokens=np.arange(3), max_new=0))
    small = _engine(params, m, n_slots=1, max_len=8, page_size=2, n_pages=3)
    with pytest.raises(ValueError, match="allocatable pages"):
        small.submit(Request(rid=2, tokens=np.arange(5), max_new=2))


def test_priority_admission_order():
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=1, max_len=16)
    reqs = [Request(rid="low-a", tokens=np.arange(4), max_new=3, priority=0),
            Request(rid="high", tokens=np.arange(5), max_new=3, priority=5),
            Request(rid="low-b", tokens=np.arange(4), max_new=3, priority=0)]
    assert [c.rid for c in eng.run(reqs)] == ["high", "low-a", "low-b"]


def test_generate_dynamic_ragged_routes_through_engine(jx):
    """A list of prompts goes through the engine, on the parameters'
    device, and gives the solo runs' tokens and JAX's."""
    jm, tm, jp, tp = _model(jx, "mamba2_1p3b", seed=5)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, tm.vocab, size=(s,)) for s in (5, 9, 7)]
    out = tdec.generate(tp, tm, prompts, n_new=4)
    assert out.shape == (3, 4) and out.device.type == "cpu"
    for i, p in enumerate(prompts):
        assert out[i].tolist() == _solo_greedy(tp, tm, p, 4, max_len=13)
    want = np.asarray(jx.dec.generate(jp, jm, prompts, n_new=4))
    np.testing.assert_array_equal(out.numpy(), want)


def test_stats_report_keys(jx):
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=2, max_len=12)
    eng.run([Request(rid=0, tokens=np.arange(4), max_new=3)])
    rep = eng.stats.report()
    from repro.serve.scheduler import EngineStats
    assert set(rep) == set(EngineStats(n_slots=2).report())
    assert rep["completed"] == 1 and rep["decode_tokens"] == 2
    json.dumps(rep)


def test_unported_paths_raise():
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=1, max_len=12)
    # adopt_compiled is ported: it refuses only another geometry
    assert eng.adopt_compiled(_engine(params, m, n_slots=1, max_len=12)) \
        is eng
    with pytest.raises(ValueError, match="adopt_compiled"):
        eng.adopt_compiled(_engine(params, m, n_slots=2, max_len=12))
    # frames on an engine without an encoder: JAX's frames-length refusal
    with pytest.raises(ValueError, match="frames length 3 != engine "
                       "enc_len 0"):
        eng.submit(Request(rid=0, tokens=np.arange(4), max_new=2,
                           frames=np.zeros((3, 4))))
    with pytest.raises(ValueError, match="idle"):
        eng.preempt(0)


def test_preempt_and_drain_release_everything():
    m, params = _port_model("mistral_nemo_12b")
    eng = _engine(params, m, n_slots=2, max_len=24, page_size=4)
    reqs = teng.synth_trace(m.vocab, 4, max_prompt=12, min_prompt=6,
                            stagger=0, seed=2)
    for r in reqs:
        eng.submit(r)
    eng.step()
    busy = [s for s in range(2) if eng.slot_req[s] is not None]
    assert busy and eng.alloc.in_use > 0
    back = [eng.preempt(s) for s in busy]
    assert {r.rid for r in back} <= {r.rid for r in reqs}
    assert eng.stats.preempted == len(busy)
    assert len(eng.drain_queued()) == len(reqs) - len(busy)
    assert eng.alloc.in_use == 0 and eng.alloc.available() == eng.n_pages - 1
    eng.alloc.check()
    # the router's seam: admission without the local queue
    assert eng.try_admit(back[0]) and not len(eng.queue)
    comps = eng.run([])
    assert [c.rid for c in comps] == [back[0].rid]
    assert list(comps[0].tokens) == _solo_greedy(
        params, m, back[0].tokens, back[0].max_new, 24)


# --- tests/test_paged_cache.py's engine cases on the port -------------------------

@pytest.mark.parametrize("arch_id,page_size",
                         [("mistral_nemo_12b", 4), ("mistral_nemo_12b", 8),
                          ("mamba2_1p3b", 4)])
def test_multi_chunk_prefill_invariance(arch_id, page_size):
    m, params = _port_model(arch_id)
    max_len = 24
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(1, m.vocab, size=s),
                    max_new=4)
            for i, s in enumerate([13, 9, 17, 6])]
    eng = _engine(params, m, n_slots=2, max_len=max_len, page_size=page_size)
    assert eng.chunk_tokens is not None
    comps = eng.run(reqs)
    assert len(comps) == len(reqs)
    for c in comps:
        r = reqs[c.rid]
        ref = _solo_greedy(params, m, r.tokens, r.max_new, max_len)
        assert list(c.tokens) == ref, (c.rid, list(c.tokens), ref)
    assert eng.stats.prefill_chunks > len(reqs)
    assert eng.alloc.in_use == 0
    eng.alloc.check()


def test_prefix_sharing_refcount_equals_n():
    m, params = _port_model("mistral_nemo_12b")
    ps, n, max_len = 4, 3, 32
    prompt = (np.arange(1, 14) * 3) % m.vocab
    shareable = (len(prompt) - 1) // ps
    reqs = [Request(rid=i, tokens=prompt.copy(), max_new=12)
            for i in range(n)]
    eng = _engine(params, m, n_slots=n, max_len=max_len, page_size=ps)
    assert eng.share_ok
    for r in reqs:
        eng.submit(r)
        for _ in range(4):
            eng.step()
    assert eng.active.sum() == n
    tables = eng.slot_pages[:, :shareable]
    for s in range(1, n):
        assert np.array_equal(tables[s], tables[0])
    for pid in tables[0]:
        assert eng.alloc.refcount[pid] == n
    assert eng.stats.prefix_hit_pages == (n - 1) * shareable
    assert eng.stats.report()["prefix_hit_rate"] > 0
    comps = eng.run([])
    ref = _solo_greedy(params, m, prompt, 12, max_len)
    assert all(list(c.tokens) == ref for c in comps)
    assert eng.alloc.in_use == 0
    eng.alloc.check()


def test_shared_page_write_forks_copy_on_write():
    """The guarded case: a write landing on a shared page forks it first,
    copying the page in every pool, and the other owner's page is left as
    it was."""
    m, params = _port_model("mistral_nemo_12b")
    eng = _engine(params, m, n_slots=2, max_len=16, page_size=4)
    eng.submit(Request(rid=0, tokens=np.arange(1, 7), max_new=4))
    eng.step()                           # prompt tokens 0..3
    eng.step()                           # 4..5, and decodes token 6
    assert eng.active[0] and eng.index[0] == 7
    pid = int(eng.slot_pages[0, 1])      # the page holding the next token
    eng.alloc.refcount[pid] += 1         # as if another slot shared it
    pools = ttfm.tree_leaves(eng.cache)     # [layers, pages, ps, Kv, hd]
    before = [pool[:, pid].clone() for pool in pools]
    eng.step()
    new = int(eng.slot_pages[0, 1])
    assert new != pid and eng.alloc.refcount[pid] == 1
    for pool, old in zip(pools, before):
        assert torch.equal(pool[:, pid], old)
        # tokens 4..6 copied; token 7 written on the copy only
        assert torch.equal(pool[:, new, :3], old[:, :3])
        assert not torch.equal(pool[:, new, 3], old[:, 3])


def test_ssd_arch_never_claims_prefix_sharing():
    m, params = _port_model("mamba2_1p3b")
    eng = _engine(params, m, n_slots=2, max_len=16, page_size=4)
    assert not eng.share_ok


def test_long_prefill_does_not_stall_short_requests(tmp_path):
    from repro_torch.obs import EngineRecorder
    m, params = _port_model("mistral_nemo_12b")
    rng = np.random.default_rng(7)
    long_req = Request(rid="long", tokens=rng.integers(1, m.vocab, size=28),
                       max_new=2)
    shorts = [Request(rid=f"s{i}", tokens=rng.integers(1, m.vocab, size=4),
                      max_new=3) for i in range(2)]
    rec = EngineRecorder()
    eng = _engine(params, m, n_slots=3, max_len=36, page_size=4,
                  recorder=rec)
    eng.submit(long_req)
    eng.step()
    for r in shorts:
        eng.submit(r)
    comps = {c.rid: c for c in eng.run([])}
    long_first = comps["long"].finished_tick - (long_req.max_new - 1)
    for i in range(2):
        assert comps[f"s{i}"].finished_tick < long_first
    with open(rec.export_trace(str(tmp_path / "trace.json"))) as f:
        events = json.load(f)["traceEvents"]
    xs = sorted((e for e in events if e.get("ph") == "X"),
                key=lambda e: e["ts"])
    ticks, cur = [], set()
    for e in xs:
        if e["name"] == "admit":
            ticks.append(cur)
            cur = set()
        cur.add(e["name"])
    ticks.append(cur)
    assert [t for t in ticks if "prefill" in t and "decode" in t]
    assert sum(1 for t in ticks if "prefill" in t) >= 7


# --- on the card -------------------------------------------------------------------

def _fused_layer(shape, seed=0):
    b, i, o = shape
    asp = tq.ASPConfig(grid_size=8, order=3)
    spec = tk.KANSpec.single(i, o, asp, backend="fused", base_activation="")
    layer = tk.deploy(tk.init(seed, spec, device="cpu"), spec).layers[0]
    gen = torch.Generator().manual_seed(seed)
    return layer, asp, tk.bound_input(torch.randn((b, i), generator=gen), asp)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TICK_SHAPES)
def test_kan_fused_at_the_engine_shapes(cuda, shape):
    """The kernel at the fused tick's 16 rows and a 64-token chunk (its
    split-k path) against the plain formula in float64 at the kernel
    tests' bar, and bitwise equal to itself on a second launch."""
    layer, asp, x = _fused_layer(shape)
    args = (layer.codes.to(cuda), layer.scale.reshape(-1).to(cuda), asp)
    got = tops.kan_spline_fused_deployed(x.to(cuda), *args,
                                         hemi=layer.hemi.to(cuda))
    again = tops.kan_spline_fused_deployed(x.to(cuda), *args,
                                           hemi=layer.hemi.to(cuda))
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
def test_ssd_scan_init_state_at_the_chunk_shape(cuda):
    """``ssd_scan`` with a carried state at mamba2-1.3b's chunk shape [1,
    256, 64, 64] (N 128, chunk 256) against the plain chunked form and the
    sequential oracle at the kernel tests' bar."""
    rng = np.random.default_rng(0)
    b, t, h, p, n = 1, 256, 64, 64, 128
    arrays = {"x": rng.normal(size=(b, t, h, p)),
              "dt": np.log1p(np.exp(rng.normal(size=(b, t, h)) - 3)),
              "a": -np.exp(rng.normal(size=h) * 0.3),
              "B": rng.normal(size=(b, t, n)) * 0.3,
              "C": rng.normal(size=(b, t, n)) * 0.3,
              "d_skip": np.ones(h),
              "init": rng.normal(size=(b, h, p, n)) * 0.5}
    cpu = {k: torch.from_numpy(v.astype(np.float32))
           for k, v in arrays.items()}
    args = [cpu[k] for k in ("x", "dt", "a", "B", "C", "d_skip")]
    before = tssd.ssd_scan.init_launches
    got_y, got_s = tops.ssd_state(*(a.to(cuda) for a in args), chunk=256,
                                  init_state=cpu["init"].to(cuda))
    torch.cuda.synchronize()
    assert tssd.ssd_scan.init_launches == before + 1
    for want_y, want_s in (
            tref.ssd_chunked_ref(*args, chunk=256, init_state=cpu["init"]),
            tref.ssd_ref(*args, cpu["init"])):
        torch.testing.assert_close(got_y.cpu(), want_y, atol=SSD_ATOL,
                                   rtol=SSD_RTOL)
        torch.testing.assert_close(got_s.cpu(), want_s, atol=SSD_ATOL,
                                   rtol=SSD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,backend", [("kan_llm", "fused"),
                                          ("mamba2_1p3b", None)])
def test_engine_on_the_card_equals_the_cpu(cuda, name, backend):
    """One set of weights served by the engine on the card (the kernels)
    and on the CPU (their plain versions): tokens equal up to the CPU run's
    first near tie."""
    m = tconfigs.get_arch(name, smoke=True).model
    if backend:
        m = dataclasses.replace(m, kan_backend=backend)
    params = ttfm.init_model(0, m, device="cpu")
    trace = dict(TRACE, n_requests=8)
    runs = {}
    for dev in ("cpu", cuda):
        eng = teng.Engine(params, m, n_slots=3, max_len=24, page_size=4,
                          device=dev)
        runs[str(dev)] = {c.rid: [int(t) for t in c.tokens]
                          for c in eng.run(teng.synth_trace(m.vocab,
                                                            **trace))}
    reqs = teng.synth_trace(m.vocab, **trace)
    compared = 0
    for rid, want in runs["cpu"].items():
        prompt = torch.as_tensor(reqs[rid].tokens).long()
        logits, cache = tdec.prefill(params, m, {"tokens": prompt[None]}, 24,
                                     last_only=True)
        cut, lg = len(want), logits[0, -1]
        for i in range(len(want)):
            top2 = torch.topk(lg, 2).values
            if float(top2[0] - top2[1]) <= 1e-3:
                cut = i
                break
            if i + 1 < len(want):
                lg, cache = tdec.decode_step(params, cache,
                                             torch.tensor([[want[i]]]),
                                             len(prompt) + i, m)
                lg = lg[0, 0]
        assert runs[str(cuda)][rid][:cut] == want[:cut], rid
        compared += cut
    assert compared > 0
