"""Multi-replica serving router: N data-parallel engines behind one queue
(port of ``repro.serve.router``; host code only, the reference's logic line
for line).

One ``Engine`` is a throughput ceiling; the same model can serve more
traffic as N *replicas* that share nothing but their frozen, deploy-once
weights. This module is the routing layer above them:

* **One global queue, FIFO preserved.** The router owns a single
  ``AdmissionQueue``; replica-local queues stay empty (dispatch goes
  through ``Engine.try_admit``, which binds a slot directly). Dispatch is
  strictly in global priority-FIFO order: the head of the queue is never
  skipped. Load and affinity only choose which replica among those able
  to admit it right now receives it; when none can, dispatch stalls.
* **Load-aware placement.** Candidates are ranked by (prefix pages already
  resident, occupied slots, pages in use, index): fewer busy slots wins,
  page-pool pressure breaks ties. The inputs are host state
  (``active``/``prefilling``, ``PagedAllocator.in_use``), so the score
  needs no device sync.
* **Prefix affinity.** For prefix-sharing architectures the router hashes
  the prompt once (``paging.page_hashes``) and probes each candidate's
  allocator (``probe_prefix``, read-only); a replica that already holds
  the shared prefix outranks every load score. Affinity only reorders
  replicas, never tokens.
* **Drain / remove with in-flight requeue.** ``drain(i)`` preempts every
  request resident on replica i (``Engine.preempt`` discards pages and
  partial tokens) and requeues them on the global queue: nothing is lost,
  and greedy decoding reruns to the same tokens. ``remove=True`` also
  stops stepping the replica for good. ``watch_preemption`` wires a
  ``dist.fault.PreemptionHandler`` to a replica so a SIGTERM (or an admin
  ``trigger()``) drains it on the next tick.
* **Closed-loop health.** ``enable_health()`` attaches a
  :class:`HealthMonitor` that polls each live replica every few ticks:
  SLO burn rates (``obs.slo``) fed from the replica's own ``EngineStats``,
  plus optional chip drift probes (``hw.health.ChipHealth``: canary rows
  and ADC saturation). A replica breaching either signal is auto-drained
  through the same lossless requeue path; the drain lands in
  ``RouterStats.drained_for_health`` and the report's ``health.events``.
  The monitor never drains the last live replica.
* **Replica-agnostic engines.** The router talks to replicas through a
  small duck-typed seam (``try_admit`` / ``step`` / ``preempt`` /
  ``drain_queued`` / the host state arrays), so tests drive it with a
  host-only fake engine over a real ``PagedAllocator``.

Aggregate throughput is **modeled-concurrent**: the replicas are stepped
one after the other in one process (on one card they also share its
device), so ``RouterStats.aggregate`` charges each replica its own busy
wall clock and models the data-parallel deployment as ``router_s +
max_i busy_s[i]``: replicas share no state, so on N cards the wall time
would follow the slowest replica plus the routing overhead.
``agg_tokens_per_s`` is that model, not a measurement of N cards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.recorder import NullRecorder
from repro_torch.obs.sketch import QuantileSketch
from repro_torch.obs.slo import (SLOMonitor, SLOObjective,
                                 default_serving_slos)
from repro_torch.serve.paging import page_hashes
from repro_torch.serve.scheduler import AdmissionQueue, Completion, Request


@dataclasses.dataclass
class RouterStats:
    """Router-level accounting: dispatch counts, drain/requeue totals, and
    the per-replica busy walls the modeled-concurrency aggregate is built
    from. ``dispatch_log`` records every placement as ``(tick, rid,
    replica)`` in dispatch order — the raw material for the FIFO and
    affinity property tests (and for debugging a misbehaving trace)."""
    n_replicas: int
    submitted: int = 0                # requests accepted into the queue
    rejected: int = 0                 # backpressure refusals
    completed: int = 0                # completions returned by step()
    requeued: int = 0                 # in-flight requests recycled by drains
    drains: int = 0                   # drain() calls
    drained_for_health: int = 0       # drains triggered by the HealthMonitor
    replicas_removed: int = 0         # drains with remove=True
    affinity_hits: int = 0            # dispatches won on resident prefix pages
    ticks: int = 0                    # router ticks (incl. fast-forwarded)
    ff_ticks: int = 0                 # idle ticks skipped via fast-forward
    router_s: float = 0.0             # wall spent scoring/dispatching
    wall_s: float = 0.0               # run() wall clock (serial stepping)
    routed: List[int] = dataclasses.field(default_factory=list)
    busy_s: List[float] = dataclasses.field(default_factory=list)
    dispatch_log: List[Tuple[int, Any, int]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self):
        if not self.routed:
            self.routed = [0] * self.n_replicas
        if not self.busy_s:
            self.busy_s = [0.0] * self.n_replicas

    def aggregate(self, per_replica: Sequence[dict]) -> dict:
        """The aggregate report: router counters + per-replica engine
        reports + the modeled-concurrent throughput.

        ``agg_tokens_per_s = tokens / (router_s + max_i busy_s[i])``:
        replicas are stepped *serially* in one process, so summed wall
        time measures nothing about the deployment — but each replica's
        own busy wall is real, and data-parallel replicas share no device
        state, so a real N-accelerator deployment finishes in (slowest
        replica + routing overhead). Balanced load => busy walls roughly
        equal => near-linear modeled scaling; imbalance or router overhead
        degrade it — exactly the two things the router controls."""
        tokens = sum(int(r.get("decode_tokens", 0)) + int(r.get("prefills", 0))
                     for r in per_replica)
        busy_max = max(self.busy_s, default=0.0)
        wall_model = self.router_s + busy_max
        agg = tokens / wall_model if wall_model > 0 else None
        return {
            "replicas": self.n_replicas,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "requeued": self.requeued,
            "drains": self.drains,
            "drained_for_health": self.drained_for_health,
            "replicas_removed": self.replicas_removed,
            "affinity_hits": self.affinity_hits,
            "routed": list(self.routed),
            "ticks": self.ticks,
            "ff_ticks": self.ff_ticks,
            "tokens": tokens,
            "wall_s": round(self.wall_s, 4),
            "router_s": round(self.router_s, 4),
            "busy_s": [round(b, 4) for b in self.busy_s],
            "busy_s_max": round(busy_max, 4),
            "agg_tokens_per_s": (round(agg, 2) if agg is not None else None),
            "per_replica": list(per_replica),
        }


class HealthMonitor:
    """Closed-loop fleet health: poll per-replica SLO burn + chip drift,
    auto-drain a breaching replica with zero lost requests.

    Every ``poll_every`` router ticks the monitor, per live replica:

    1. feeds that replica's ``SLOMonitor`` from its ``EngineStats`` deltas
       (new TTFT/TPOT samples; completions as good events and rejections +
       preemptions as bad events on the error objective; global queue
       depth against the queue-wait objective) and advances the SLO tick
       window;
    2. probes the replica's chip-health source, if attached (anything with
       ``probe(age) -> dict`` carrying ``max_rel_dev`` — ``hw.health
       .ChipHealth`` is the real one), at ``age = tick``;
    3. drains the replica via ``Router.drain`` when either signal breaches
       (SLO burn above factor on both windows, or canary deviation above
       ``drift_threshold``). The drain requeues all in-flight work on the
       global queue — greedy decode is deterministic, so the re-run on a
       healthy replica emits identical tokens (the launcher's ``--check``
       holds the token multiset to a healthy single engine's).

    The monitor never drains the LAST live replica: one degraded replica
    still finishing work beats a fleet that deadlocks with everything
    queued and nowhere to run — the breach is recorded as a suppressed
    event instead. Draining/removed replicas are skipped entirely (their
    stats are frozen mid-evacuation); ``Router.resume`` re-enters them
    into the polling set. Every action lands in ``events`` as ``{"tick",
    "replica", "reasons", "action"}``, the audit trail surfaced in
    ``Router.report()["health"]``.
    """

    def __init__(self, router: "Router", *, poll_every: int = 4,
                 drift_threshold: float = 0.05,
                 slos: Optional[Callable[[], Sequence[SLOObjective]]] = None):
        if poll_every < 1:
            raise ValueError(f"poll_every must be >= 1, got {poll_every}")
        self.router = router
        self.poll_every = int(poll_every)
        self.drift_threshold = float(drift_threshold)
        make = slos if slos is not None else default_serving_slos
        n = len(router.replicas)
        self.slo = [SLOMonitor(make()) for _ in range(n)]
        self._cursor = [{"ttft": 0, "tpot": 0, "good": 0, "bad": 0}
                        for _ in range(n)]
        self._chips: Dict[int, Any] = {}
        self.last_probe: Dict[int, dict] = {}
        self.events: List[dict] = []
        self.polls = 0

    def attach_chip(self, replica: int, source) -> None:
        """Register a chip-health source (duck-typed ``probe(age)``) for
        ``replica`` — probed on every poll, breach drains the replica."""
        self._chips[replica] = source

    def _feed_slo(self, i: int) -> None:
        """Advance replica ``i``'s SLO window by the stats accumulated
        since the last poll (cursor-based, so samples are never double
        counted). Feeds only the objectives present in the monitor, so a
        custom ``slos`` factory may track any subset of the defaults."""
        stats, mon, cur = (self.router.replicas[i].stats, self.slo[i],
                           self._cursor[i])
        have = mon.trackers
        if "ttft" in have:
            for v in stats.ttft_s[cur["ttft"]:]:
                mon.observe("ttft", v)
        cur["ttft"] = len(stats.ttft_s)
        if "tpot" in have:
            for v in stats.tpot_s[cur["tpot"]:]:
                mon.observe("tpot", v)
        cur["tpot"] = len(stats.tpot_s)
        good, bad = stats.completed, stats.rejected + stats.preempted
        if "errors" in have:
            for _ in range(good - cur["good"]):
                mon.observe_event("errors", True)
            for _ in range(bad - cur["bad"]):
                mon.observe_event("errors", False)
        cur["good"], cur["bad"] = good, bad
        if "queue_wait" in have:
            mon.observe("queue_wait", float(len(self.router.queue)))
        mon.tick()

    def _sync_error_cursor(self, i: int) -> None:
        """Snap replica ``i``'s bad-event cursor to now — called right
        after the monitor itself drains it, so the preemptions of its own
        corrective action don't count as fresh errors on resume."""
        stats = self.router.replicas[i].stats
        self._cursor[i]["bad"] = stats.rejected + stats.preempted

    def poll(self, tick: int) -> List[dict]:
        """One health pass at router tick ``tick`` (no-op except every
        ``poll_every`` ticks). Returns the events recorded this pass."""
        if tick % self.poll_every != 0:
            return []
        self.polls += 1
        fired: List[dict] = []
        r = self.router
        for i in range(len(r.replicas)):
            if r.removed[i] or r.draining[i]:
                continue
            self._feed_slo(i)
            reasons = [f"slo:{name}" for name in self.slo[i].breaching()]
            chip = self._chips.get(i)
            if chip is not None:
                probe = chip.probe(float(tick))
                self.last_probe[i] = probe
                if probe["max_rel_dev"] > self.drift_threshold:
                    reasons.append(f"drift:{probe['max_rel_dev']:.4f}")
            if not reasons:
                continue
            live = [j for j in range(len(r.replicas))
                    if not r.removed[j] and not r.draining[j]]
            if len(live) <= 1:
                action = "suppressed_last_replica"
            else:
                r.drain(i)
                r.stats.drained_for_health += 1
                self._sync_error_cursor(i)
                action = "drained"
            ev = {"tick": int(tick), "replica": i, "reasons": reasons,
                  "action": action}
            self.events.append(ev)
            fired.append(ev)
        return fired

    def summary(self) -> dict:
        """JSON-ready state for ``Router.report()``: per-replica SLO
        verdicts, last drift probes, and the drain audit trail."""
        return {
            "poll_every": self.poll_every,
            "drift_threshold": self.drift_threshold,
            "polls": self.polls,
            "slo_verdicts": {str(i): m.verdicts()
                             for i, m in enumerate(self.slo)},
            "drift": {str(i): {"age": p["age"],
                               "max_rel_dev": p["max_rel_dev"],
                               "adc_saturation": p["adc_saturation"]}
                      for i, p in self.last_probe.items()},
            "events": list(self.events),
        }


class Router:
    """Route requests across N geometry-homogeneous engine replicas.

    Parameters
    ----------
    replicas : sequence of ``Engine``-seam objects (see module docstring).
               All must agree on (cfg, n_slots, max_len, page_size,
               n_pages) — replicas differ only in traffic, never in
               geometry or numerics, so request validation and warm-start
               ``adopt_compiled`` hold across the whole fleet.
    queue    : optional global ``AdmissionQueue`` (bounded => backpressure
               at the router; replica-local queues are not used).
    affinity : enable prefix-affinity placement (default True). Off, the
               score is purely load-based; outputs are identical either
               way.
    recorder : optional ``repro_torch.obs.EngineRecorder`` for *router-level*
               request lifecycle (submit/reject + requeue-resubmits).
               Build each replica with ``recorder.for_replica(i)`` so
               engine metrics get per-replica labels while sharing this
               recorder's trace and TTFT clock.
    """

    def __init__(self, replicas: Sequence, *,
                 queue: Optional[AdmissionQueue] = None,
                 affinity: bool = True, recorder=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("Router needs at least one replica")
        geo0 = self._geometry(replicas[0])
        for i, eng in enumerate(replicas[1:], start=1):
            if self._geometry(eng) != geo0:
                raise ValueError(
                    f"Router: replica {i} geometry {self._geometry(eng)[1:]} "
                    f"differs from replica 0 {geo0[1:]} (replicas must be "
                    "homogeneous in cfg/n_slots/max_len/page_size/n_pages)")
        self.replicas = replicas
        self.queue = queue if queue is not None else AdmissionQueue()
        self.affinity = affinity
        self.obs = recorder if recorder is not None else NullRecorder()
        self.page_size = replicas[0].page_size
        self.tick_no = 0
        self.stats = RouterStats(n_replicas=len(replicas))
        self.draining = [False] * len(replicas)
        self.removed = [False] * len(replicas)
        self.health: Optional[HealthMonitor] = None
        self._handlers: Dict[int, Any] = {}
        self._scheduled: List[Tuple[int, int, bool]] = []

    def enable_health(self, **kwargs) -> HealthMonitor:
        """Attach a :class:`HealthMonitor` (kwargs forwarded to it) and
        return it — ``step()`` polls it from then on. Attach chip-health
        sources on the returned monitor via ``attach_chip``."""
        self.health = HealthMonitor(self, **kwargs)
        return self.health

    @staticmethod
    def _geometry(eng) -> tuple:
        return (eng.cfg, eng.n_slots, eng.max_len, eng.page_size,
                eng.n_pages)

    # -- intake --------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request on the global queue. False = backpressure
        (bounded queue full); ValueError when the request can never fit
        the replicas' shared geometry."""
        self.replicas[0].validate_request(req)
        ok = self.queue.submit(req)
        if ok:
            self.stats.submitted += 1
            self.obs.on_submit(req, self.tick_no)
        else:
            self.stats.rejected += 1
            self.obs.on_reject(req)
        return ok

    # -- placement -----------------------------------------------------------

    def _place(self, req: Request) -> Optional[int]:
        """Admit ``req`` on the best currently-able replica; None when no
        live replica can take it this tick. Ranking: most resident prefix
        pages first (affinity), then fewest occupied slots, then fewest
        pages in use. ``try_admit`` re-checks pages transactionally, so a
        candidate that looked free but cannot cover the worst case simply
        falls through to the next."""
        prompt = np.asarray(req.tokens).ravel()
        s = int(prompt.shape[-1])
        digests = None
        order = []
        for i, eng in enumerate(self.replicas):
            if self.removed[i] or self.draining[i]:
                continue
            if not (~eng.active & ~eng.prefilling).any():
                continue                              # no free slot
            matched = 0
            if self.affinity and eng.share_ok and s > 1:
                if digests is None:
                    digests = page_hashes(prompt, self.page_size)
                matched = eng.alloc.probe_prefix(
                    digests[:(s - 1) // self.page_size])
            load = int(eng.active.sum()) + int(eng.prefilling.sum())
            order.append((-matched, load, eng.alloc.in_use, i))
        for neg_matched, _load, _pages, i in sorted(order):
            if self.replicas[i].try_admit(req):
                if neg_matched < 0:
                    self.stats.affinity_hits += 1
                return i
        return None

    def _dispatch(self) -> None:
        """Drain the ready head of the global queue onto replicas, in
        strict priority-FIFO order. Stops at the first head no replica
        can admit — the head is never skipped in favor of a later request
        (the global FIFO-within-priority invariant)."""
        while True:
            req = self.queue.peek(self.tick_no)
            if req is None:
                return
            idx = self._place(req)
            if idx is None:
                return
            self.queue.pop(self.tick_no)
            self.stats.routed[idx] += 1
            self.stats.dispatch_log.append((self.tick_no, req.rid, idx))

    # -- drain / remove ------------------------------------------------------

    def drain(self, replica: int, *, remove: bool = False) -> int:
        """Evacuate a replica: requeue its locally-queued requests, then
        preempt every in-flight slot (admission order, so the requeue
        sequence is deterministic) back onto the global queue. Requeued
        requests keep their priority but rejoin the *back* of their
        priority class — they re-dispatch after requests of equal priority
        that were already waiting. The requeue bypasses a bounded queue's
        cap (losing accepted work is worse than briefly exceeding the
        bound). The replica stops receiving dispatches until ``resume``;
        with ``remove=True`` it also stops being stepped, permanently.
        Returns the number of requests requeued."""
        if self.removed[replica]:
            raise ValueError(f"drain: replica {replica} was already removed")
        eng = self.replicas[replica]
        self.draining[replica] = True
        requeued: List[Request] = list(eng.drain_queued())
        busy = [s for s in range(eng.n_slots) if eng.slot_req[s] is not None]
        busy.sort(key=lambda s: (int(eng.slot_admitted[s]), s))
        for slot in busy:
            requeued.append(eng.preempt(slot))
        for req in requeued:
            self.queue.submit(req, force=True)
            self.obs.on_submit(req, self.tick_no)
        self.stats.drains += 1
        self.stats.requeued += len(requeued)
        if remove:
            self.removed[replica] = True
            self.stats.replicas_removed += 1
            self._handlers.pop(replica, None)
        return len(requeued)

    def remove(self, replica: int) -> int:
        """``drain(replica, remove=True)``: evacuate and retire for good."""
        return self.drain(replica, remove=True)

    def resume(self, replica: int) -> None:
        """Reopen a drained (not removed) replica for dispatch."""
        if self.removed[replica]:
            raise ValueError(f"resume: replica {replica} was removed")
        self.draining[replica] = False

    def schedule_drain(self, replica: int, tick: int, *,
                       remove: bool = False) -> None:
        """Drain ``replica`` at the start of the first step with
        ``tick_no >= tick`` — the test/bench hook for mid-trace drains."""
        self._scheduled.append((tick, replica, remove))

    def watch_preemption(self, replica: int, handler) -> None:
        """Bind a ``dist.fault.PreemptionHandler`` to a replica: the first
        step that sees ``handler.should_stop`` drains it (in-flight work
        requeued onto the surviving replicas). A SIGTERM-installed handler
        makes eviction notice graceful; ``handler.trigger()`` is the
        admin/test path."""
        self._handlers[replica] = handler

    # -- the tick ------------------------------------------------------------

    def step(self) -> List[Completion]:
        """One router tick: poll the health monitor (when attached — may
        auto-drain a breaching replica), fire due scheduled/signalled
        drains, dispatch
        the ready queue head(s) in global FIFO order, then step every live
        replica once (serially — per-replica busy wall is accumulated in
        ``stats.busy_s``). Returns all completions from this tick."""
        t0 = time.perf_counter()
        if self.health is not None:
            self.health.poll(self.tick_no)
        for i, h in list(self._handlers.items()):
            if h.should_stop and not self.draining[i] and not self.removed[i]:
                self.drain(i)
        if self._scheduled:
            due = [s for s in self._scheduled if s[0] <= self.tick_no]
            self._scheduled = [s for s in self._scheduled
                               if s[0] > self.tick_no]
            for _tick, idx, rm in due:
                if not self.removed[idx]:
                    self.drain(idx, remove=rm)
        self._dispatch()
        self.stats.router_s += time.perf_counter() - t0
        done: List[Completion] = []
        for i, eng in enumerate(self.replicas):
            if self.removed[i]:
                continue
            t1 = time.perf_counter()
            done.extend(eng.step())
            self.stats.busy_s[i] += time.perf_counter() - t1
        self.tick_no += 1
        self.stats.ticks += 1
        self.stats.completed += len(done)
        return done

    def _busy(self) -> bool:
        return any((eng.active.any() or eng.prefilling.any())
                   for i, eng in enumerate(self.replicas)
                   if not self.removed[i])

    def _fast_forward(self, tick: int) -> None:
        """Jump the whole fleet to ``tick`` (all live replicas idle, only
        future arrivals queued). Live replicas advance in lockstep and
        book the skipped ticks as idle/fast-forwarded, mirroring
        ``Engine.run``'s accounting."""
        skip = tick - self.tick_no
        self.tick_no = tick
        self.stats.ticks += skip
        self.stats.ff_ticks += skip
        for i, eng in enumerate(self.replicas):
            if self.removed[i]:
                continue
            eng.tick_no += skip
            eng.stats.ticks += skip
            eng.stats.idle_ticks += skip
            eng.stats.ff_ticks += skip

    def run(self, requests: Sequence[Request] = (),
            max_ticks: int = 1_000_000) -> List[Completion]:
        """Submit ``requests`` then tick until the queue drains and every
        live replica is idle. Same contract as ``Engine.run``: bounded-
        queue backpressure is absorbed (held back and resubmitted as the
        queue drains — nothing silently dropped), and fully-idle stretches
        fast-forward to the next arrival tick."""
        pending = list(requests)
        t0 = time.perf_counter()
        out: List[Completion] = []
        while pending or self._busy() or len(self.queue):
            while pending and (self.queue.max_pending is None
                               or len(self.queue) < self.queue.max_pending):
                self.submit(pending.pop(0))
            if not self._busy() and len(self.queue):
                nxt = self.queue.next_arrival()
                if nxt is not None and nxt > self.tick_no:
                    self._fast_forward(nxt)
            if self.stats.ticks >= max_ticks:
                raise RuntimeError(f"router exceeded max_ticks={max_ticks}")
            out.extend(self.step())
        self.stats.wall_s += time.perf_counter() - t0
        return out

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """``RouterStats.aggregate`` over the live fleet: router counters,
        modeled-concurrent ``agg_tokens_per_s``, one engine report per
        replica (tagged with its routing share and drain state), a
        ``fleet`` section merging every replica's latency sketches into
        one snapshot (count-exact merge, same alpha bound as the
        per-replica sketches), and — when a health monitor is attached —
        its ``health`` summary (SLO verdicts, drift probes, drain
        events)."""
        per = []
        ttft_sks, tpot_sks = [], []
        for i, eng in enumerate(self.replicas):
            r = {"replica": i,
                 "routed": self.stats.routed[i],
                 "draining": self.draining[i],
                 "removed": self.removed[i]}
            r.update(eng.stats.report())
            per.append(r)
            ttft, tpot = eng.stats.latency_sketches()
            ttft_sks.append(ttft)
            tpot_sks.append(tpot)
        agg = self.stats.aggregate(per)
        fleet_ttft = QuantileSketch.merge_all(ttft_sks)
        fleet_tpot = QuantileSketch.merge_all(tpot_sks)
        agg["fleet"] = {
            "ttft_sketch": fleet_ttft.percentiles() if fleet_ttft else None,
            "tpot_sketch": fleet_tpot.percentiles() if fleet_tpot else None,
        }
        if self.health is not None:
            agg["health"] = self.health.summary()
        return agg
