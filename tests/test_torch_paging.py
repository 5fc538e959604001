"""Port parity for the serving engine's host bookkeeping: the paged-KV
allocator and prefix hashes (``repro_torch.serve.paging``) and the
mergeable quantile sketch (``repro_torch.obs.sketch``), against the JAX
package's copies.

Each case of ``tests/test_paged_cache.py``'s host layer and of
``tests/test_sketch_slo.py``'s sketch layer runs on the port, and the same
inputs go through both packages: the page digests, the allocator's answers
along a randomized trace (page ids, refcounts, live and peak counts) and
the sketches' state and quantiles must be equal, exactly (both are plain
Python and numpy; only a sketch's float ``sum`` may differ in its last
bits, which it does only between two orders of the same samples).
"""
import json
import math
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs.sketch import DEFAULT_ALPHA, QuantileSketch  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402
from repro_torch.serve.paging import (GARBAGE_PAGE,  # noqa: E402
                                      PagedAllocator, page_hashes)
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jx():
    """The JAX package's copies (importing ``repro.serve`` imports jax)."""
    pytest.importorskip("jax")
    from repro.obs import sketch
    from repro.serve import paging
    return types.SimpleNamespace(paging=paging, sketch=sketch)


# --- page_hashes -----------------------------------------------------------

def test_page_hashes_chain_property(jx):
    ps = 4
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    b = np.array([1, 2, 3, 4, 5, 6, 99, 8, 9, 10, 11, 12])
    ha, hb = page_hashes(a, ps), page_hashes(b, ps)
    assert len(ha) == len(a) // ps and len(hb) == len(b) // ps
    assert ha[0] == hb[0]
    assert ha[1] != hb[1]
    c = np.array([0, 2, 3, 4, 5, 6, 7, 8])
    hc = page_hashes(c, ps)
    assert hc[0] != ha[0] and hc[1] != ha[1]
    assert page_hashes(a, ps, salt=b"x") != ha
    for toks in (a, b, c):
        assert page_hashes(toks, ps) == jx.paging.page_hashes(toks, ps)
    assert (page_hashes(a, ps, salt=b"x")
            == jx.paging.page_hashes(a, ps, salt=b"x"))


def test_page_hashes_same_prefix_same_digests(jx):
    rng = np.random.default_rng(0)
    ps = 3
    prefix = rng.integers(0, 50, size=9)
    t1 = np.concatenate([prefix, rng.integers(0, 50, size=7)])
    t2 = np.concatenate([prefix, rng.integers(0, 50, size=4)])
    h1, h2 = page_hashes(t1, ps), page_hashes(t2, ps)
    assert h1[:3] == h2[:3]
    assert h1 == jx.paging.page_hashes(t1, ps)
    assert h2 == jx.paging.page_hashes(t2, ps)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint16])
@pytest.mark.parametrize("page_size,n", [(1, 5), (4, 17), (64, 640),
                                         (64, 63)])
def test_page_hashes_equal_jax(jx, dtype, page_size, n):
    """The digests are the reference's, whatever the prompt's integer type
    (both hash the tokens as int64 bytes) and a torch prompt too."""
    toks = np.random.default_rng(n).integers(0, 4096, n).astype(dtype)
    want = jx.paging.page_hashes(toks, page_size)
    assert page_hashes(toks, page_size) == want
    assert page_hashes(torch.from_numpy(toks.astype(np.int64)),
                       page_size) == want
    assert len(want) == n // page_size


# --- PagedAllocator ----------------------------------------------------------

def _random_trace(paging, seed=42, n_ops=400, ps=2, n_pages=24, model=True):
    """The randomized admit/evict/fork trace of ``test_paged_cache.py`` on
    ``paging``'s allocator. With ``model`` it also checks the independent
    model there (no non-prefix aliasing, refcounts, forks, no leak).
    Returns what the allocator answered, step by step."""
    rng = np.random.default_rng(seed)
    alloc = paging.PagedAllocator(n_pages, ps)
    live, page_prefix, trace = {}, {}, []
    next_rid = 0

    def admit():
        nonlocal next_rid
        n_tok = int(rng.integers(2, 13))
        toks = rng.integers(0, 3, size=n_tok)
        digests = paging.page_hashes(toks, ps)
        matched = alloc.match_prefix(digests[:max(0, (n_tok - 1) // ps)])
        need = -(-n_tok // ps) - len(matched)
        ok = alloc.reserve(need)
        trace.append(("admit", tuple(matched), need, ok))
        if not ok:
            for pid in matched:
                alloc.release(pid)
            return
        pages = list(matched) + [alloc.alloc(reserved=True)
                                 for _ in range(need)]
        for i, pid in enumerate(pages):
            pfx = toks[:(i + 1) * ps]
            if i < len(matched):
                if model:
                    assert np.array_equal(page_prefix[pid], pfx), \
                        f"non-prefix aliasing on page {pid}"
            else:
                page_prefix[pid] = pfx
                if (i + 1) * ps <= n_tok:
                    alloc.register_hash(pid, digests[i])
        trace.append(("pages", tuple(pages)))
        live[next_rid] = pages
        next_rid += 1

    def evict():
        rid = int(rng.choice(list(live)))
        for pid in live.pop(rid):
            alloc.release(pid)
        trace.append(("evict", rid))

    def fork():
        shared = [pid for pid in set(p for r in live.values() for p in r)
                  if alloc.refcount[pid] > 1]
        if not shared or alloc.available() <= 0:
            return
        pid = int(rng.choice(sorted(shared)))
        rid = [r for r, pages in live.items() if pid in pages][0]
        before = alloc.refcount[pid]
        new = alloc.fork(pid)
        if model:
            assert new != pid and alloc.refcount[new] == 1
            assert alloc.refcount[pid] == before - 1
        pages = live[rid]
        pages[pages.index(pid)] = new
        page_prefix[new] = np.array(page_prefix[pid], copy=True)
        trace.append(("fork", pid, new))

    for _ in range(n_ops):
        op = rng.random()
        if op < 0.5 or not live:
            admit()
        elif op < 0.85:
            evict()
        else:
            fork()
        alloc.check()
        counts = {}
        for pages in live.values():
            for pid in pages:
                counts[pid] = counts.get(pid, 0) + 1
        if model:
            for pid, n in counts.items():
                assert alloc.refcount[pid] == n, (pid, n)
            assert alloc.in_use == len(counts)
        trace.append(("state", alloc.in_use, alloc.in_use_peak,
                      alloc.available(), tuple(int(r) for r in
                                               alloc.refcount)))
    while live:
        evict()
    alloc.check()
    if model:
        assert alloc.in_use == 0, "pages leaked after full eviction"
    trace.append(("end", alloc.in_use, alloc.in_use_peak))
    return trace


@pytest.mark.parametrize("seed", [42, 7, 2024])
def test_allocator_randomized_trace_equals_jax(jx, seed):
    """No leak, no non-prefix aliasing, CoW forks that keep the shared
    page; and the port's allocator answers the reference's, step by step."""
    got = _random_trace(tpaging, seed)
    want = _random_trace(jx.paging, seed, model=False)
    assert got == want
    assert any(step[0] == "fork" for step in got)
    assert any(step[0] == "admit" and step[1] for step in got)


def test_allocator_reservation_gate_and_garbage_page():
    alloc = PagedAllocator(5, 4)
    assert alloc.available() == 4
    assert alloc.reserve(3)
    assert not alloc.reserve(2)
    a = alloc.alloc(reserved=True)
    assert a != GARBAGE_PAGE
    b = alloc.alloc()
    with pytest.raises(RuntimeError):
        alloc.alloc()
    alloc.release(a), alloc.release(b)
    alloc.unreserve(2)
    alloc.check()
    with pytest.raises(ValueError):
        alloc.release(GARBAGE_PAGE)


def test_allocator_cached_free_revival(jx):
    out = []
    for paging in (jx.paging, tpaging):
        alloc = paging.PagedAllocator(6, 2)
        d = paging.page_hashes(np.array([7, 8, 9, 10]), 2)
        p0, p1 = alloc.alloc(), alloc.alloc()
        alloc.register_hash(p0, d[0])
        alloc.register_hash(p1, d[1])
        alloc.release(p0), alloc.release(p1)
        assert alloc.in_use == 0
        revived = alloc.match_prefix(d)
        assert revived == [p0, p1]
        assert alloc.refcount[p0] == 1 and alloc.refcount[p1] == 1
        alloc.check()
        out.append((revived, list(alloc.refcount)))
    assert out[0] == out[1]


# --- the quantile sketch -------------------------------------------------------

def _exact_quantile(sorted_vals, q):
    return sorted_vals[int(math.floor(q * (len(sorted_vals) - 1)))]


def _workloads(rng):
    return {
        "uniform_ms": [rng.uniform(1e-3, 50e-3) for _ in range(400)],
        "lognormal_s": [rng.lognormvariate(-2.0, 1.0) for _ in range(400)],
        "bimodal": ([rng.uniform(1e-4, 2e-4) for _ in range(200)]
                    + [rng.uniform(1.0, 2.0) for _ in range(200)]),
        "heavy_tail": [rng.paretovariate(1.5) * 1e-3 for _ in range(400)],
        "tiny_n": [rng.uniform(0.1, 1.0) for _ in range(3)],
        "with_zeros": [0.0] * 17 + [rng.uniform(1e-3, 1.0)
                                    for _ in range(100)],
    }


QS = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)


def _same_sketch(jx, got, want_samples=None, want=None):
    """``got`` (port) against the reference's sketch of the same samples:
    state, sum and quantiles equal."""
    if want is None:
        want = jx.sketch.QuantileSketch.from_samples(want_samples)
    assert got.to_dict() == want.to_dict()
    assert [got.quantile(q) for q in QS] == [want.quantile(q) for q in QS]
    assert got.percentiles() == want.percentiles()


def test_sketch_relative_error_bound_across_workloads(jx):
    rng = random.Random(1234)
    for name, vals in _workloads(rng).items():
        sk = QuantileSketch.from_samples(vals)
        ordered = sorted(vals)
        for q in QS:
            exact = _exact_quantile(ordered, q)
            est = sk.quantile(q)
            if exact == 0.0:
                assert est == 0.0, (name, q)
            else:
                assert abs(est - exact) / exact <= sk.alpha + 1e-9, (name, q)
        _same_sketch(jx, sk, vals)


def test_sketch_exact_side_counters_and_extremes(jx):
    sk, jsk = QuantileSketch(), jx.sketch.QuantileSketch()
    for v in (0.0, 0.0, -1.5, 3.0, float("nan"), float("inf")):
        sk.observe(v)
        jsk.observe(v)
    assert sk.count == 4
    assert sk.zero_count == 2 and sk.negative_count == 1
    assert sk.min == -1.5 and sk.max == 3.0
    assert sk.quantile(0.0) == -1.5
    assert sk.quantile(1.0) <= 3.0
    assert QuantileSketch().quantile(0.5) is None
    _same_sketch(jx, sk, want=jsk)


def test_sketch_bounded_memory_collapse(jx):
    sk = QuantileSketch(alpha=0.01, max_bins=16)
    jsk = jx.sketch.QuantileSketch(alpha=0.01, max_bins=16)
    for e in range(-6, 6):
        for m in (1.0, 2.0, 5.0):
            sk.observe(m * 10.0 ** e, n=10)
            jsk.observe(m * 10.0 ** e, n=10)
    assert len(sk.bins) <= sk.max_bins
    assert sk.collapsed >= 1
    assert sk.quantile(0.99) == pytest.approx(5e5, rel=0.05)
    _same_sketch(jx, sk, want=jsk)


def _state(sk):
    d = sk.to_dict()
    d.pop("sum")
    return d


def test_merge_equals_concat(jx):
    rng = random.Random(99)
    for vals in _workloads(rng).values():
        cut = len(vals) // 3
        a = QuantileSketch.from_samples(vals[:cut])
        b = QuantileSketch.from_samples(vals[cut:])
        merged = a.merge(b)
        whole = QuantileSketch.from_samples(vals)
        assert _state(merged) == _state(whole)
        assert merged.sum == pytest.approx(whole.sum, rel=1e-9)
        jmerged = jx.sketch.QuantileSketch.from_samples(vals[:cut]).merge(
            jx.sketch.QuantileSketch.from_samples(vals[cut:]))
        _same_sketch(jx, merged, want=jmerged)


def test_merge_commutative_associative(jx):
    rng = random.Random(7)
    parts = [[rng.lognormvariate(-2.0, 1.0) for _ in range(150)]
             for _ in range(3)]
    a, b, c = (QuantileSketch.from_samples(p) for p in parts)
    assert _state(a.merge(b)) == _state(b.merge(a))
    assert _state(a.merge(b).merge(c)) == _state(a.merge(b.merge(c)))
    assert a.count == 150 and b.count == 150
    fleet = QuantileSketch.merge_all([a, b, c])
    assert _state(fleet) == _state(a.merge(b).merge(c))
    assert QuantileSketch.merge_all([]) is None
    jfleet = jx.sketch.QuantileSketch.merge_all(
        [jx.sketch.QuantileSketch.from_samples(p) for p in parts])
    _same_sketch(jx, fleet, want=jfleet)


def test_merge_rejects_mismatched_alpha():
    with pytest.raises(ValueError, match="alpha"):
        QuantileSketch(0.01).merge(QuantileSketch(0.02))


def test_serialization_round_trip_bit_exact(jx):
    """Round trip, and across the packages: a sketch either one wrote is
    read by the other as the same sketch."""
    rng = random.Random(42)
    sk = QuantileSketch.from_samples(
        rng.lognormvariate(-2.0, 1.0) for _ in range(300))
    wire = json.loads(json.dumps(sk.to_dict()))
    back = QuantileSketch.from_dict(wire)
    assert back.to_dict() == sk.to_dict()
    assert back.quantile(0.95) == sk.quantile(0.95)
    with pytest.raises(ValueError, match="obs-sketch/v1"):
        QuantileSketch.from_dict({"schema": "bogus"})
    assert jx.sketch.QuantileSketch.from_dict(wire).to_dict() == wire
    assert QuantileSketch.from_dict(
        jx.sketch.QuantileSketch.from_dict(wire).to_dict()).to_dict() == wire
    assert DEFAULT_ALPHA == jx.sketch.DEFAULT_ALPHA


def test_from_samples_order_independent(jx):
    rng = random.Random(5)
    vals = [rng.uniform(1e-3, 10.0) for _ in range(200)]
    shuffled = list(vals)
    rng.shuffle(shuffled)
    assert _state(QuantileSketch.from_samples(vals)) == _state(
        QuantileSketch.from_samples(shuffled))
    _same_sketch(jx, QuantileSketch.from_samples(shuffled), shuffled)
