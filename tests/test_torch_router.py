"""Port parity for the multi-replica serving router
(``repro_torch.serve.router``) against the JAX package's.

* ``tests/test_router.py``'s property suites (completion equivalence,
  global FIFO within priority, drain and requeue, affinity only placing,
  construction, backpressure, the aggregate report, the queue and stats
  boundaries, per-replica recorder labels, the HealthMonitor's drift and
  SLO drains) run against the port's ``Router``, over a host-only fake
  engine built on the port's ``PagedAllocator``.
* The same random traces go through the reference's ``Router`` over a fake
  fleet on its own allocator and through the port's: the dispatch logs,
  the ``RouterStats`` counters and the health event trails are equal,
  with drains, removals, preemption handlers and drift probes.
* Real engines: mistral-nemo SMOKE (the reference's params carried across)
  through a 2-replica fleet gives the reference fleet's dispatch log and
  completions, also across a drain; a ``kan_llm`` fleet on ``fused`` and a
  mamba2 SMOKE fleet with a drain give the single engine's tokens.
"""
import dataclasses
import hashlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist.fault import PreemptionHandler  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.obs import recorder as trecorder  # noqa: E402
from repro_torch.obs.sketch import QuantileSketch  # noqa: E402
from repro_torch.obs.slo import SLOObjective  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.router import Router, RouterStats  # noqa: E402
from repro_torch.serve.scheduler import (EMPTY_PERCENTILES,  # noqa: E402
                                         AdmissionQueue, EngineStats,
                                         Request)
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

VOCAB = 97
CHUNK = 4          # fake prefill tokens consumed per tick
FAKE_CFG = "fake-cfg-v1"
# the counters of RouterStats compared with the reference's (its times are
# wall clocks and differ)
ROUTER_COUNTERS = ("n_replicas", "submitted", "rejected", "completed",
                   "requeued", "drains", "drained_for_health",
                   "replicas_removed", "affinity_hits", "ticks", "ff_ticks",
                   "routed", "dispatch_log")

PORT = types.SimpleNamespace(
    PagedAllocator=tpaging.PagedAllocator, page_hashes=tpaging.page_hashes,
    GARBAGE_PAGE=tpaging.GARBAGE_PAGE, AdmissionQueue=AdmissionQueue,
    EngineStats=EngineStats, Completion=tsched.Completion,
    Request=Request, NullRecorder=trecorder.NullRecorder,
    EngineRecorder=trecorder.EngineRecorder, Router=Router,
    PreemptionHandler=PreemptionHandler, SLOObjective=SLOObjective)


@pytest.fixture(scope="module")
def jx():
    """The reference's serving pieces, imported only by the parity cases."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_arch
    from repro.dist.fault import PreemptionHandler as JPreemption
    from repro.models import transformer
    from repro.obs import recorder
    from repro.obs.slo import SLOObjective as JSLO
    from repro.serve import engine, paging, router, scheduler
    return types.SimpleNamespace(
        jax=jax, get_arch=get_arch, tfm=transformer, eng=engine,
        PagedAllocator=paging.PagedAllocator, page_hashes=paging.page_hashes,
        GARBAGE_PAGE=paging.GARBAGE_PAGE,
        AdmissionQueue=scheduler.AdmissionQueue,
        EngineStats=scheduler.EngineStats, Completion=scheduler.Completion,
        Request=scheduler.Request, NullRecorder=recorder.NullRecorder,
        EngineRecorder=recorder.EngineRecorder, Router=router.Router,
        PreemptionHandler=JPreemption, SLOObjective=JSLO)


def expected_token(prompt, k: int) -> int:
    """The k-th token the fake model emits for ``prompt``."""
    h = hashlib.blake2b(np.asarray(prompt, np.int64).tobytes()
                        + int(k).to_bytes(4, "little"), digest_size=4)
    return int.from_bytes(h.digest(), "little") % VOCAB


class FakeEngine:
    """``tests/test_router.py``'s host-only replica over a real
    ``PagedAllocator`` of package ``pk`` (the port's or the reference's):
    admission, prefix pages and reservations are production code; prefill
    consumes CHUNK prompt tokens a tick and decode emits
    ``expected_token``."""

    def __init__(self, pk, *, n_slots, max_len, page_size, n_pages=None,
                 recorder=None):
        self.pk = pk
        self.cfg = FAKE_CFG
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.n_slot_pages = -(-max_len // page_size)
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.n_slot_pages + 1)
        self.alloc = pk.PagedAllocator(self.n_pages, page_size)
        self.share_ok = True
        self.enc_len = 0
        self.queue = pk.AdmissionQueue()
        self.obs = recorder if recorder is not None else pk.NullRecorder()
        self.tick_no = 0
        self.stats = pk.EngineStats(n_slots=n_slots, page_size=page_size,
                                    n_pages=self.n_pages)
        self.active = np.zeros(n_slots, dtype=bool)
        self.prefilling = np.zeros(n_slots, dtype=bool)
        self.index = np.zeros(n_slots, dtype=np.int64)
        self.remaining = np.zeros(n_slots, dtype=np.int64)
        self.slot_req = [None] * n_slots
        self.slot_tokens = [[] for _ in range(n_slots)]
        self.slot_admitted = np.zeros(n_slots, dtype=np.int64)
        self.slot_pages = np.full((n_slots, self.n_slot_pages),
                                  pk.GARBAGE_PAGE, dtype=np.int32)
        self.slot_reserved = np.zeros(n_slots, dtype=np.int64)
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)
        self.slot_prompt = [None] * n_slots
        self.slot_hashes = [[] for _ in range(n_slots)]

    def _worst_case_pages(self, s, max_new):
        return -(-(s + max_new - 1) // self.page_size)

    def validate_request(self, req):
        s = int(np.asarray(req.tokens).shape[-1])
        if req.max_new < 1:
            raise ValueError(f"request {req.rid!r}: max_new must be >= 1")
        if s + req.max_new - 1 > self.max_len:
            raise ValueError(f"request {req.rid!r}: over slot capacity")
        if self._worst_case_pages(s, req.max_new) > self.n_pages - 1:
            raise ValueError(f"request {req.rid!r}: over pool capacity")

    def try_admit(self, req):
        free = np.flatnonzero(~self.active & ~self.prefilling)
        if not len(free):
            return False
        prompt = np.asarray(req.tokens).ravel()
        s = int(prompt.shape[-1])
        digests = self.pk.page_hashes(prompt, self.page_size)
        matched = self.alloc.match_prefix(digests[:(s - 1) // self.page_size])
        need = self._worst_case_pages(s, req.max_new) - len(matched)
        if not self.alloc.reserve(need):
            for pid in matched:
                self.alloc.release(pid)
            return False
        slot = int(free[0])
        prompt = prompt.astype(np.int64)
        n_prompt_pages = -(-s // self.page_size)
        self.slot_pages[slot, :len(matched)] = matched
        reserved = need
        for i in range(len(matched), n_prompt_pages):
            self.slot_pages[slot, i] = self.alloc.alloc(reserved=True)
            reserved -= 1
        self.slot_reserved[slot] = reserved
        self.slot_pos[slot] = len(matched) * self.page_size
        self.slot_prompt[slot] = prompt
        self.slot_hashes[slot] = digests
        self.prefilling[slot] = True
        self.slot_req[slot] = req
        self.slot_tokens[slot] = []
        self.slot_admitted[slot] = self.tick_no
        self.stats.slot_served[slot] += 1
        self.stats.prefix_hit_pages += len(matched)
        self.stats.prefix_eligible_pages += (s - 1) // self.page_size
        self.obs.on_admit(req, slot, self.tick_no)
        return True

    def _finish_prefill(self, slot):
        req = self.slot_req[slot]
        for i, d in enumerate(self.slot_hashes[slot]):
            self.alloc.register_hash(int(self.slot_pages[slot, i]), d)
        self.obs.on_first_token(req, self.tick_no)
        self.prefilling[slot] = False
        self.active[slot] = True
        self.index[slot] = int(self.slot_prompt[slot].shape[-1])
        self.remaining[slot] = req.max_new - 1
        self.slot_tokens[slot] = [expected_token(req.tokens, 0)]
        self.stats.prefills += 1
        if self.remaining[slot] <= 0:
            return [self._evict(slot)]
        return []

    def _release_slot(self, slot):
        for pg in range(self.n_slot_pages):
            pid = int(self.slot_pages[slot, pg])
            if pid != self.pk.GARBAGE_PAGE:
                self.alloc.release(pid)
        self.slot_pages[slot, :] = self.pk.GARBAGE_PAGE
        self.alloc.unreserve(int(self.slot_reserved[slot]))
        self.slot_reserved[slot] = 0
        self.active[slot] = False
        self.prefilling[slot] = False
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self.slot_prompt[slot] = None
        self.slot_hashes[slot] = []

    def _evict(self, slot):
        req = self.slot_req[slot]
        comp = self.pk.Completion(
            rid=req.rid, tokens=np.asarray(self.slot_tokens[slot]),
            reason="length", slot=slot,
            admitted_tick=int(self.slot_admitted[slot]),
            finished_tick=self.tick_no)
        self._release_slot(slot)
        self.stats.completed += 1
        self.stats.evicted_length += 1
        self.obs.on_evict(comp)
        return comp

    def preempt(self, slot):
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"preempt: slot {slot} is idle")
        self._release_slot(slot)
        self.stats.preempted += 1
        self.obs.on_preempt(req, slot)
        return req

    def drain_queued(self):
        return self.queue.drain()

    def step(self):
        done = []
        for slot in np.flatnonzero(self.prefilling):
            slot = int(slot)
            s = int(self.slot_prompt[slot].shape[-1])
            pos = int(self.slot_pos[slot])
            self.slot_pos[slot] = min(pos + CHUNK, s)
            self.stats.prefill_chunks += 1
            if self.slot_pos[slot] == s:
                done += self._finish_prefill(slot)
        act = [int(s) for s in np.flatnonzero(self.active)]
        if act:
            for slot in act:
                pg = int(self.index[slot]) // self.page_size
                if int(self.slot_pages[slot, pg]) == self.pk.GARBAGE_PAGE:
                    self.slot_pages[slot, pg] = self.alloc.alloc(
                        reserved=True)
                    self.slot_reserved[slot] -= 1
            self.stats.occupancy_ticks += len(act)
            self.stats.decode_tokens += len(act)
            for slot in act:
                req = self.slot_req[slot]
                tok = expected_token(req.tokens, len(self.slot_tokens[slot]))
                self.slot_tokens[slot].append(tok)
                self.index[slot] += 1
                self.remaining[slot] -= 1
                if self.remaining[slot] <= 0:
                    done.append(self._evict(slot))
        elif not self.prefilling.any():
            self.stats.idle_ticks += 1
        self.stats.pages_in_use_peak = self.alloc.in_use_peak
        self.tick_no += 1
        self.stats.ticks += 1
        return done


def _fleet(n, pk=PORT, *, n_slots=2, max_len=24, page_size=4,
           recorder=None):
    return [FakeEngine(pk, n_slots=n_slots, max_len=max_len,
                       page_size=page_size,
                       recorder=(recorder.for_replica(i) if recorder else
                                 None))
            for i in range(n)]


def _random_trace(rng, n_reqs, pk=PORT, *, max_len=24, share_prob=0.4):
    """``tests/test_router.py``'s random prompts, budgets, priorities and
    arrivals; with ``share_prob`` a request reuses a previous prompt's
    prefix."""
    reqs, prompts = [], []
    for i in range(n_reqs):
        if prompts and rng.rand() < share_prob:
            base = prompts[rng.randint(len(prompts))]
            keep = rng.randint(1, len(base) + 1)
            extra = rng.randint(0, VOCAB, size=rng.randint(0, 5))
            toks = np.concatenate([base[:keep], extra])[:max_len - 8]
        else:
            toks = rng.randint(0, VOCAB, size=rng.randint(1, 13))
        toks = toks.astype(np.int64)
        prompts.append(toks)
        reqs.append(pk.Request(rid=i, tokens=toks,
                               max_new=int(rng.randint(1, 8)),
                               priority=int(rng.randint(0, 3)),
                               arrival=int(rng.randint(0, 60))))
    return reqs


def _completion_map(comps):
    out = {}
    for c in comps:
        assert c.rid not in out, f"request {c.rid} completed twice"
        out[c.rid] = [int(t) for t in c.tokens]
    return out


def _assert_tokens_expected(reqs, comps):
    got = _completion_map(comps)
    assert sorted(got) == sorted(r.rid for r in reqs), "lost/extra requests"
    for r in reqs:
        want = [expected_token(r.tokens, k) for k in range(r.max_new)]
        assert got[r.rid] == want, (r.rid, got[r.rid], want)


def _assert_fleet_clean(router):
    for i, eng in enumerate(router.replicas):
        eng.alloc.check()
        if not router.removed[i]:
            assert not eng.active.any() and not eng.prefilling.any()


def _check_global_fifo(reqs, dispatch_log):
    """Each dispatched rid is the eligible head by (priority desc,
    submission order) among the requests that have arrived."""
    pending = {r.rid: (r.priority, seq, r.arrival)
               for seq, r in enumerate(reqs)}
    for tick, rid, _replica in dispatch_log:
        prio, seq, arrival = pending[rid]
        assert arrival <= tick, f"rid {rid} dispatched before arrival"
        for orid, (oprio, oseq, oarr) in pending.items():
            if orid == rid or oarr > tick:
                continue
            assert (-oprio, oseq) >= (-prio, seq), (rid, orid, tick)
        del pending[rid]


# ---------------------------------------------------------------------------
# tests/test_router.py's suites on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_replicas", [1, 2, 3, 4])
def test_completion_multiset_equals_single_engine(seed, n_replicas):
    rng = np.random.RandomState(seed)
    reqs = _random_trace(rng, 50)
    single = Router(_fleet(1)).run(reqs)
    multi = Router(_fleet(n_replicas)).run(reqs)
    assert _completion_map(multi) == _completion_map(single)
    _assert_tokens_expected(reqs, multi)


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
@pytest.mark.parametrize("n_replicas", [2, 4])
def test_fifo_within_priority_across_replicas(seed, n_replicas):
    rng = np.random.RandomState(seed)
    reqs = _random_trace(rng, 60)
    router = Router(_fleet(n_replicas))
    router.run(reqs)
    log = router.stats.dispatch_log
    assert len(log) == len(reqs)
    _check_global_fifo(reqs, log)
    _assert_fleet_clean(router)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_drain_requeues_in_flight_and_completes_all(seed):
    rng = np.random.RandomState(seed)
    reqs = _random_trace(rng, 50)
    n_replicas = 3
    router = Router(_fleet(n_replicas))
    drain_ticks = {}
    for i in range(1, n_replicas):
        t = int(rng.randint(5, 40))
        drain_ticks[i] = t
        router.schedule_drain(i, t, remove=(i == n_replicas - 1))
    comps = router.run(reqs)
    _assert_tokens_expected(reqs, comps)
    assert router.stats.drains == len(drain_ticks)
    assert router.stats.requeued == sum(e.stats.preempted
                                        for e in router.replicas)
    for tick, _rid, idx in router.stats.dispatch_log:
        if idx in drain_ticks:
            assert tick < drain_ticks[idx]
    assert router.removed[n_replicas - 1]
    _assert_fleet_clean(router)


def test_drain_actually_preempts_in_flight_work():
    reqs = [Request(rid=i, tokens=np.arange(1, 9, dtype=np.int64),
                    max_new=12, arrival=0) for i in range(4)]
    router = Router(_fleet(2, max_len=24))
    router.schedule_drain(1, 6)
    comps = router.run(reqs)
    _assert_tokens_expected(reqs, comps)
    assert router.replicas[1].stats.preempted > 0
    assert router.stats.requeued == router.replicas[1].stats.preempted
    _assert_fleet_clean(router)


def test_preemption_handler_drains_on_trigger():
    """The port's ``dist.fault.PreemptionHandler`` drains its replica on the
    next step after ``trigger()``."""
    reqs = [Request(rid=i, tokens=np.arange(1, 7, dtype=np.int64),
                    max_new=10, arrival=0) for i in range(4)]
    router = Router(_fleet(2))
    handler = PreemptionHandler(install=False)
    router.watch_preemption(1, handler)
    for r in reqs:
        assert router.submit(r)
    out = []
    for _ in range(4):
        out += router.step()
    assert router.replicas[1].stats.prefills > 0
    handler.trigger()
    while router._busy() or len(router.queue):
        out += router.step()
    assert router.stats.drains == 1
    assert router.draining[1] and not router.removed[1]
    _assert_tokens_expected(reqs, out)
    router.resume(1)
    assert not router.draining[1]


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_affinity_never_changes_tokens(seed):
    rng = np.random.RandomState(seed)
    reqs = _random_trace(rng, 50, share_prob=0.7)
    r_on = Router(_fleet(3), affinity=True)
    on = r_on.run(reqs)
    r_off = Router(_fleet(3), affinity=False)
    off = r_off.run(reqs)
    assert _completion_map(on) == _completion_map(off)
    _assert_tokens_expected(reqs, on)
    assert r_on.stats.affinity_hits > 0
    assert r_off.stats.affinity_hits == 0


def test_router_rejects_heterogeneous_replicas():
    a = FakeEngine(PORT, n_slots=2, max_len=24, page_size=4)
    b = FakeEngine(PORT, n_slots=2, max_len=32, page_size=4)
    with pytest.raises(ValueError, match="homogeneous"):
        Router([a, b])
    with pytest.raises(ValueError, match="at least one"):
        Router([])


def test_router_bounded_queue_backpressure_absorbed():
    rng = np.random.RandomState(13)
    reqs = _random_trace(rng, 30)
    router = Router(_fleet(2), queue=AdmissionQueue(max_pending=3))
    comps = router.run(reqs)
    _assert_tokens_expected(reqs, comps)


def test_router_validates_requests_loudly():
    router = Router(_fleet(2, max_len=16))
    with pytest.raises(ValueError, match="max_new"):
        router.submit(Request(rid=0, tokens=np.arange(4), max_new=0))
    with pytest.raises(ValueError):
        router.submit(Request(rid=1, tokens=np.arange(4), max_new=64))


def test_router_stats_aggregate_modeled_concurrency():
    rs = RouterStats(n_replicas=2)
    rs.busy_s = [2.0, 1.0]
    rs.router_s = 1.0
    rep = rs.aggregate([{"decode_tokens": 10, "prefills": 2},
                        {"decode_tokens": 8, "prefills": 1}])
    assert rep["tokens"] == 21
    assert rep["busy_s_max"] == 2.0
    assert rep["agg_tokens_per_s"] == pytest.approx(21 / 3.0)
    assert json.dumps(rep, allow_nan=False)


def test_router_report_carries_per_replica_rows():
    rng = np.random.RandomState(14)
    reqs = _random_trace(rng, 20)
    router = Router(_fleet(2))
    router.run(reqs)
    rep = router.report()
    assert rep["replicas"] == 2
    assert rep["completed"] == len(reqs)
    assert sum(rep["routed"]) == len(reqs)
    assert len(rep["per_replica"]) == 2
    assert rep["per_replica"][0]["replica"] == 0
    assert rep["per_replica"][0]["routed"] == rep["routed"][0]
    assert json.dumps(rep, allow_nan=False)


def test_admission_queue_boundaries():
    """The queue's empty, all-future, exact-arrival, mixed, drain-order and
    forced-submit paths (``tests/test_router.py``'s five cases)."""
    q = AdmissionQueue()
    assert len(q) == 0 and q.peek(0) is None and q.pop(0) is None
    assert q.next_arrival() is None
    r5 = Request(rid=0, tokens=[1], max_new=1, arrival=5)
    r9 = Request(rid=1, tokens=[1], max_new=1, arrival=9)
    assert q.submit(r9) and q.submit(r5)
    assert q.peek(4) is None and q.pop(4) is None
    assert q.next_arrival() == 5 and len(q) == 2
    assert q.peek(5) is r5 and q.pop(5) is r5 and q.pop(5) is None
    assert q.next_arrival() == 9 and q.pop(9) is r9
    q = AdmissionQueue()
    q.submit(Request(rid=0, tokens=[1], max_new=1, arrival=7))
    q.submit(Request(rid=1, tokens=[1], max_new=1, arrival=2))
    q.peek(3)
    assert q.next_arrival() == 2
    q = AdmissionQueue()
    q.submit(Request(rid="lo", tokens=[1], max_new=1, priority=0, arrival=0))
    q.submit(Request(rid="hi", tokens=[1], max_new=1, priority=1, arrival=0))
    q.submit(Request(rid="fut", tokens=[1], max_new=1, arrival=50))
    q.peek(0)
    assert [r.rid for r in q.drain()] == ["hi", "lo", "fut"]
    assert len(q) == 0
    q = AdmissionQueue(max_pending=1)
    assert q.submit(Request(rid=0, tokens=[1], max_new=1))
    assert not q.submit(Request(rid=1, tokens=[1], max_new=1))
    assert q.submit(Request(rid=1, tokens=[1], max_new=1), force=True)
    assert len(q) == 2


def test_engine_stats_empty_and_non_finite():
    rep = EngineStats(n_slots=2).report()
    assert rep["ttft_s"] == EMPTY_PERCENTILES
    assert rep["tpot_s"] == EMPTY_PERCENTILES
    assert rep["mean_occupancy"] == 0.0 and rep["preempted"] == 0
    json.dumps(rep, allow_nan=False)
    assert EngineStats(n_slots=0).report()["mean_occupancy"] == 0.0
    s = EngineStats(n_slots=1)
    s.ttft_s = [0.1, float("nan"), 0.3, float("inf")]
    lat = s.latency_report()
    assert lat["ttft"]["n"] == 2
    assert lat["ttft"]["p50"] == pytest.approx(0.2)
    s.ttft_s = [float("nan")]
    assert s.latency_report()["ttft"] == EMPTY_PERCENTILES


def test_recorder_replica_labels_and_balanced_preempt_spans():
    parent = trecorder.EngineRecorder()
    router = Router(_fleet(2, recorder=parent), recorder=parent)
    reqs = [Request(rid=i, tokens=np.arange(1, 9, dtype=np.int64),
                    max_new=12, arrival=0) for i in range(4)]
    router.schedule_drain(1, 6)
    comps = router.run(reqs)
    _assert_tokens_expected(reqs, comps)
    assert router.stats.requeued > 0
    keys = parent.metrics.snapshot()["metrics"].keys()
    assert "serve_submitted_total" in keys
    assert 'serve_prefill_total{replica="0"}' in keys
    assert 'serve_prefill_total{replica="1"}' in keys
    assert 'serve_preempted_total{replica="1"}' in keys
    opens, preempt_ends = {}, 0
    for ev in parent.trace.events():
        if ev.get("ph") == "b" and ev.get("cat") == "request":
            opens[ev["id"]] = opens.get(ev["id"], 0) + 1
        elif ev.get("ph") == "e" and ev.get("cat") == "request":
            opens[ev["id"]] = opens.get(ev["id"], 0) - 1
            if (ev.get("args") or {}).get("reason") == "preempt":
                preempt_ends += 1
    assert preempt_ends == router.stats.requeued
    assert all(v == 0 for v in opens.values()), opens


# --- HealthMonitor -----------------------------------------------------------

def _quiet_slos(pk=PORT):
    return (pk.SLOObjective("ttft", threshold=1e9),)


def _bad_slos(pk=PORT):
    return (pk.SLOObjective("queue_wait", objective=0.9, threshold=-1.0,
                            long_window=8, short_window=2, min_events=4),)


class FakeProbe:
    """A chip-health source whose deviation ramps with age."""

    def __init__(self, rate=0.0):
        self.rate = rate

    def probe(self, age):
        return {"age": float(age),
                "max_rel_dev": round(self.rate * age, 6),
                "adc_saturation": 0, "adc_saturation_total": 0,
                "tiles": []}


def test_health_drift_drain_zero_lost_requests():
    rng = np.random.RandomState(3)
    reqs = _random_trace(rng, 40)
    single = _completion_map(Router(_fleet(1)).run(reqs))
    router = Router(_fleet(2))
    mon = router.enable_health(poll_every=2, drift_threshold=0.05,
                               slos=_quiet_slos)
    mon.attach_chip(1, FakeProbe(rate=0.01))
    comps = router.run(reqs)
    assert router.draining[1]
    assert router.stats.drained_for_health == 1
    drained = [e for e in mon.events if e["action"] == "drained"]
    assert len(drained) == 1 and drained[0]["replica"] == 1
    assert drained[0]["reasons"][0].startswith("drift:")
    assert drained[0]["tick"] == 6
    _assert_tokens_expected(reqs, comps)
    assert _completion_map(comps) == single
    _assert_fleet_clean(router)
    assert mon.last_probe[1]["age"] == 6.0
    assert mon.summary()["events"] == mon.events


def test_health_never_drains_last_replica():
    rng = np.random.RandomState(4)
    reqs = _random_trace(rng, 20)
    router = Router(_fleet(2))
    mon = router.enable_health(poll_every=2, drift_threshold=0.05,
                               slos=_quiet_slos)
    mon.attach_chip(0, FakeProbe(rate=1.0))
    mon.attach_chip(1, FakeProbe(rate=1.0))
    comps = router.run(reqs)
    assert router.stats.drained_for_health == 1
    assert router.draining[0] and not router.draining[1]
    actions = [(e["replica"], e["action"]) for e in mon.events]
    assert actions[0] == (0, "drained")
    assert (1, "suppressed_last_replica") in actions
    assert all(a == "suppressed_last_replica" for r, a in actions if r == 1)
    _assert_tokens_expected(reqs, comps)
    _assert_fleet_clean(router)


def test_health_slo_burn_drains():
    rng = np.random.RandomState(5)
    reqs = _random_trace(rng, 30)
    router = Router(_fleet(2))
    mon = router.enable_health(poll_every=1, slos=_bad_slos)
    comps = router.run(reqs)
    drained = [e for e in mon.events if e["action"] == "drained"]
    assert len(drained) == 1 and drained[0]["reasons"] == ["slo:queue_wait"]
    assert router.stats.drained_for_health == 1
    assert any(e["action"] == "suppressed_last_replica" for e in mon.events)
    verdicts = mon.summary()["slo_verdicts"]
    assert "burning" in verdicts[str(drained[0]["replica"])].values() or \
        "burning" in verdicts[str(1 - drained[0]["replica"])].values()
    _assert_tokens_expected(reqs, comps)
    _assert_fleet_clean(router)


def test_report_fleet_sketch_and_health_section():
    router = Router(_fleet(2))
    router.enable_health(poll_every=4)
    router.replicas[0].stats.ttft_s = [0.1] * 50
    router.replicas[1].stats.ttft_s = [0.3] * 50
    rep = router.report()
    fleet = rep["fleet"]["ttft_sketch"]
    assert fleet["n"] == 100
    assert fleet["p50"] == pytest.approx(0.1, rel=0.02)
    assert fleet["p95"] == pytest.approx(0.3, rel=0.02)
    whole = QuantileSketch.from_samples([0.1] * 50 + [0.3] * 50)
    assert fleet == whole.percentiles()
    assert rep["fleet"]["tpot_sketch"] is None
    assert rep["drained_for_health"] == 0
    assert rep["health"]["polls"] == 0
    assert set(rep["health"]["slo_verdicts"]) == {"0", "1"}
    bare = Router(_fleet(1)).report()
    assert "fleet" in bare and "health" not in bare


def test_health_monitor_rejects_bad_poll():
    with pytest.raises(ValueError, match="poll_every"):
        Router(_fleet(1)).enable_health(poll_every=0)


# ---------------------------------------------------------------------------
# the same traces through the reference's Router and the port's
# ---------------------------------------------------------------------------

def _counters(stats):
    return {k: getattr(stats, k) for k in ROUTER_COUNTERS}


def _drive(pk, scenario, seed):
    """One scenario on package ``pk``'s Router over fake replicas on its
    own allocator: (router counters, completions, health events)."""
    rng = np.random.RandomState(seed)
    reqs = _random_trace(rng, 40, pk, share_prob=0.5)
    n = 3
    queue = pk.AdmissionQueue(max_pending=4) if scenario == "bounded" \
        else None
    router = pk.Router(_fleet(n, pk), queue=queue,
                       affinity=scenario != "no_affinity")
    mon = None
    handler = None
    if scenario == "drain":
        router.schedule_drain(1, 9)
        router.schedule_drain(2, 17, remove=True)
    elif scenario == "preempt":
        handler = pk.PreemptionHandler(install=False)
        router.watch_preemption(2, handler)
        step = router.step

        def step_and_trigger():
            if router.tick_no == 12:
                handler.trigger()
            return step()
        router.step = step_and_trigger
    elif scenario == "drift":
        mon = router.enable_health(poll_every=2, drift_threshold=0.05,
                                   slos=lambda: _quiet_slos(pk))
        mon.attach_chip(1, FakeProbe(rate=0.01))
        mon.attach_chip(2, FakeProbe(rate=0.004))
    elif scenario == "slo":
        mon = router.enable_health(poll_every=1, slos=lambda: _bad_slos(pk))
    comps = router.run(reqs)
    return (_counters(router.stats), _completion_map(comps),
            list(mon.events) if mon is not None else None,
            [list(map(int, e.stats.slot_served)) for e in router.replicas])


@pytest.mark.parametrize("scenario", ["plain", "no_affinity", "bounded",
                                      "drain", "preempt", "drift", "slo"])
@pytest.mark.parametrize("seed", [21, 22])
def test_router_equals_the_reference(jx, scenario, seed):
    """Dispatch log, RouterStats counters, completions, per-slot service
    counts and the health event trail equal the reference's on the same
    trace."""
    want = _drive(jx, scenario, seed)
    got = _drive(PORT, scenario, seed)
    assert got[0]["dispatch_log"] == want[0]["dispatch_log"]
    assert got == want
    if scenario in ("drain", "preempt"):
        assert got[0]["requeued"] > 0 or got[0]["drains"] > 0
    if scenario in ("drift", "slo"):
        assert any(e["action"] == "drained" for e in got[2])


def test_router_ranking_and_requeue_order_equal_the_reference(jx):
    """The ranking tuple ``(-matched, load, in_use, index)`` and the drain's
    requeue order (local queue first, then slots by admission tick):
    a hand-made fleet where each criterion decides one dispatch."""
    def run(pk):
        router = pk.Router(_fleet(3, pk, n_slots=3))
        prompt = np.arange(1, 14, dtype=np.int64)
        reqs = [pk.Request(rid=f"p{i}", tokens=prompt, max_new=6,
                           arrival=0 if i == 0 else 5 + i) for i in range(3)]
        reqs += [pk.Request(rid=f"x{i}", tokens=np.arange(20, 23 + i,
                                                          dtype=np.int64),
                            max_new=4, arrival=i) for i in range(6)]
        router.schedule_drain(0, 9)
        comps = router.run(reqs)
        return router.stats.dispatch_log, _completion_map(comps), \
            router.stats.affinity_hits
    assert run(PORT) == run(jx)


# ---------------------------------------------------------------------------
# real engines
# ---------------------------------------------------------------------------

def _real_fleet(n, params, m, **kw):
    fleet = [teng.Engine(params, m, device="cpu", **kw)]
    for _ in range(n - 1):
        fleet.append(teng.Engine(fleet[0].params, m, device="cpu", **kw)
                     .adopt_compiled(fleet[0]))
    return fleet


def _jax_fleet(jx, n, params, m, **kw):
    fleet = [jx.eng.Engine(params, m, **kw)]
    for _ in range(n - 1):
        fleet.append(jx.eng.Engine(fleet[0].params, m, **kw)
                     .adopt_compiled(fleet[0]))
    return fleet


def _carried(jx, name, seed):
    jm = jx.get_arch(name, smoke=True).model
    tm = tconfigs.get_arch(name, smoke=True).model
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(seed), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


def test_router_real_engines_equal_the_reference_fleet(jx):
    """mistral-nemo SMOKE with the reference's params: a 2-replica fleet on
    a shared-prefix trace gives the reference fleet's dispatch log and
    completions and the port's single engine's tokens, and so does a
    fleet drained mid-trace."""
    jm, tm, jp, tp = _carried(jx, "mistral_nemo_12b", 0)
    trace = dict(max_prompt=10, min_prompt=4, max_new=6, min_new=3,
                 stagger=2, common_prefix=8, seed=3)
    kw = dict(n_slots=2, max_len=24, page_size=4)
    jr = jx.Router(_jax_fleet(jx, 2, jp, jm, **kw))
    want = _completion_map(jr.run(jx.eng.synth_trace(jm.vocab, 8, **trace)))
    reqs = teng.synth_trace(tm.vocab, 8, **trace)
    single = _completion_map(teng.Engine(tp, tm, device="cpu", **kw)
                             .run(reqs))
    router = Router(_real_fleet(2, tp, tm, **kw))
    got = _completion_map(router.run(reqs))
    assert got == want == single
    assert router.stats.dispatch_log == jr.stats.dispatch_log
    assert router.report()["affinity_hits"] > 0
    drained = Router(_real_fleet(2, tp, tm, **kw))
    drained.schedule_drain(1, 5)
    assert _completion_map(drained.run(reqs)) == single
    assert drained.stats.drains == 1 and drained.stats.requeued > 0


def test_router_real_mamba2_drain_equals_the_reference(jx):
    """mamba2 SMOKE (chunked prefill with carried SSD state, no prefix
    sharing): a drained 2-replica fleet gives the reference's drained
    fleet's completions and dispatch log, and its single engine's
    tokens."""
    jm, tm, jp, tp = _carried(jx, "mamba2_1p3b", 1)
    trace = dict(max_prompt=10, min_prompt=4, max_new=6, min_new=4,
                 stagger=1, seed=5)
    kw = dict(n_slots=2, max_len=24)
    jr = jx.Router(_jax_fleet(jx, 2, jp, jm, **kw))
    jr.schedule_drain(1, 4)
    want = _completion_map(jr.run(jx.eng.synth_trace(jm.vocab, 6, **trace)))
    reqs = teng.synth_trace(tm.vocab, 6, **trace)
    single = _completion_map(teng.Engine(tp, tm, device="cpu", **kw)
                             .run(reqs))
    router = Router(_real_fleet(2, tp, tm, **kw))
    router.schedule_drain(1, 4)
    got = _completion_map(router.run(reqs))
    assert got == want == single
    assert router.stats.dispatch_log == jr.stats.dispatch_log
    assert router.stats.requeued == jr.stats.requeued > 0


def test_router_kan_llm_fused_fleet_equals_single_engine():
    """``kan_llm`` SMOKE on ``fused`` (the port's own seeded weights): the
    replicas share one deploy, and a 3-replica fleet with a drain and a
    health drain gives the single engine's tokens."""
    m = dataclasses.replace(tconfigs.get_arch("kan_llm", smoke=True).model,
                            kan_backend="fused")
    params = ttfm.init_model(0, m, device="cpu")
    kw = dict(n_slots=2, max_len=40, page_size=8)
    reqs = teng.synth_trace(m.vocab, 10, max_prompt=12, min_prompt=4,
                            max_new=8, min_new=3, stagger=1,
                            common_prefix=8, seed=2)
    single = _completion_map(teng.Engine(params, m, device="cpu", **kw)
                             .run(reqs))
    fleet = _real_fleet(3, params, m, **kw)
    assert all(e.params["stages"][0]["l0"]["kan"].layers[0].codes
               is fleet[0].params["stages"][0]["l0"]["kan"].layers[0].codes
               for e in fleet)
    router = Router(fleet)
    router.schedule_drain(2, 6)
    mon = router.enable_health(poll_every=2, drift_threshold=0.05,
                               slos=_quiet_slos)
    mon.attach_chip(1, FakeProbe(rate=0.01))
    got = _completion_map(router.run(reqs))
    assert got == single
    assert router.stats.drains == 2 and router.stats.drained_for_health == 1
