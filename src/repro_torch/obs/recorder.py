"""Engine-facing recording API: NullRecorder (default, no-op) and
EngineRecorder (metrics + trace + compile profiling in one object).

A copy of ``repro.obs.recorder`` (the port imports nothing of ``repro``),
except that a phase opens a ``TraceRecorder.span`` (a profiler range too,
while torch.profiler records) and no cost gauges are set: the port has no
compiler to estimate FLOPs or bytes.

The serving engine does not talk to registries or ring buffers directly —
it calls a small semantic vocabulary (``on_submit`` / ``on_admit`` /
``on_first_token`` / ``on_decode_tick`` / ``on_evict`` / ``phase`` /
``on_compile``) on whatever recorder it was built with:

* :class:`NullRecorder` — the default. Every hook is a ``pass`` and
  ``phase()`` hands back a shared do-nothing context manager, so the
  disabled hot path costs an attribute lookup and nothing else (no
  ``perf_counter`` calls, no event objects, no change to the device work — the
  batching-invariance and requant-free pins run against this path).
* :class:`EngineRecorder` — owns a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  and a :class:`~repro_torch.obs.trace.TraceRecorder`, translates each hook into
  counters/histograms *and* Chrome trace events, and accumulates
  :class:`~repro_torch.obs.profile.CompileEvent` records from profiled jits.

``snapshot()`` is the one-stop description of the stack: metrics (TTFT /
TPOT / queue-wait / tick-phase histograms, compile counters, any chip
telemetry published into the same registry) + trace summary + the raw
compile event list. Schema ``obs/v1`` — validated by
``benchmarks/records_check.py``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TID_REQUEST, TraceRecorder

SNAPSHOT_SCHEMA = "obs/v1"

#: queue-wait is measured in engine ticks, not seconds: powers of two up to
#: 1024 ticks cover everything a sane trace produces
QUEUE_WAIT_BUCKETS = tuple(float(2 ** i) for i in range(11))

_NULL_CTX = contextlib.nullcontext()


class NullRecorder:
    """Do-nothing recorder: the engine's default. Keeps the tick path free
    of timing calls; every hook is a no-op."""

    enabled = False
    metrics: Optional[MetricsRegistry] = None
    trace: Optional[TraceRecorder] = None

    def phase(self, name: str):
        """Shared do-nothing context manager (no timer, no allocation)."""
        return _NULL_CTX

    def on_submit(self, req, tick: int) -> None:
        """Request accepted by the admission queue."""

    def on_reject(self, req) -> None:
        """Submit refused (queue backpressure)."""

    def on_admit(self, req, slot: int, tick: int) -> None:
        """Request dequeued into a decode slot."""

    def on_first_token(self, req, tick: int) -> Optional[float]:
        """Prefill produced the first token; returns TTFT seconds (None
        here — only the recording subclass measures)."""
        return None

    def on_decode_tick(self, n_active: int, dur_s: float) -> None:
        """One fused decode tick finished (n_active tokens produced)."""

    def on_evict(self, comp) -> None:
        """Request left its slot (eos or length)."""

    def on_preempt(self, req, slot: int) -> None:
        """Request forcibly evicted mid-flight (replica drain); the router
        will requeue it, which re-fires ``on_submit``."""

    def on_page_pool(self, in_use: int, n_pages: int) -> None:
        """Per-tick page-pool occupancy."""

    def on_prefix(self, matched: int, eligible: int) -> None:
        """Prefix-cache outcome of one admission (pages hit vs probed)."""

    def on_compile(self, event) -> None:
        """A profiled callable met a new shape key (``obs.profile``)."""

    def snapshot(self) -> dict:
        """Telemetry summary; empty for the no-op recorder."""
        return {}


class EngineRecorder(NullRecorder):
    """Metrics + trace + compile profiling for one engine (or several —
    sharing one recorder across engines merges their telemetry).

    ``labels`` (optional) is merged into every metric this recorder
    creates: the multi-replica router builds one child per replica via
    :meth:`for_replica`, so each engine's counters land on distinct
    ``{replica="i"}``-labelled series in the *shared* registry while trace
    spans, compile events, and the request TTFT clock stay merged (a
    request submitted at the router and first-tokened on a replica still
    gets one coherent TTFT sample and one balanced async span)."""

    enabled = True

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceRecorder] = None,
                 trace_capacity: int = 65536,
                 labels: Optional[Dict[str, str]] = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.trace = (trace if trace is not None
                      else TraceRecorder(capacity=trace_capacity))
        self.labels = dict(labels) if labels else None
        self.compile_events: list = []
        # rid -> (submit wall perf_counter, submit tick)
        self._submitted: Dict[object, Tuple[float, int]] = {}
        m = self.metrics
        lbl = self._labels
        self._submitted_c = m.counter(
            "serve_submitted_total", "requests accepted by the queue",
            labels=lbl())
        self._rejected_c = m.counter(
            "serve_rejected_total", "submits refused (backpressure)",
            labels=lbl())
        self._prefill_c = m.counter(
            "serve_prefill_total", "prefill-on-admit runs", labels=lbl())
        self._queue_wait_h = m.histogram(
            "serve_queue_wait_ticks", "ticks between arrival and admission",
            buckets=QUEUE_WAIT_BUCKETS, labels=lbl())
        self._ttft_h = m.histogram(
            "serve_ttft_seconds", "submit -> first token (prefill) latency",
            labels=lbl())
        self._tpot_h = m.histogram(
            "serve_tpot_seconds", "per-token decode latency (fused tick "
            "wall time, one observation per token generated)", labels=lbl())
        self._active_g = m.gauge(
            "serve_active_slots", "slots decoding in the latest tick",
            labels=lbl())
        self._tokens_c = m.counter(
            "serve_decode_tokens_total", "tokens produced by decode ticks",
            labels=lbl())
        self._pages_g = m.gauge(
            "serve_pages_in_use", "live KV pages after the latest tick",
            labels=lbl())
        self._prefix_hit_c = m.counter(
            "serve_prefix_hit_total", "prompt pages served from the prefix "
            "cache (physical page shared, prefill skipped)", labels=lbl())
        self._prefix_query_c = m.counter(
            "serve_prefix_query_total", "prompt pages eligible for prefix "
            "matching at admission", labels=lbl())

    def _labels(self, extra: Optional[Dict[str, str]] = None):
        """This recorder's base labels merged with ``extra``; None when
        both are empty, so an unlabelled recorder keeps the historical
        bare metric keys byte-for-byte."""
        if not self.labels:
            return extra
        if not extra:
            return self.labels
        return {**self.labels, **extra}

    def for_replica(self, replica) -> "EngineRecorder":
        """A child recorder for one router replica: same registry, trace
        buffer, compile-event list, and submit clock; metrics additionally
        labelled ``{replica="..."}``. Give each replica engine its child
        and the router the parent — ``snapshot()`` on any of them sees the
        whole topology."""
        child = EngineRecorder(
            registry=self.metrics, trace=self.trace,
            labels=self._labels({"replica": str(replica)}))
        child.compile_events = self.compile_events
        child._submitted = self._submitted
        return child

    # -- request lifecycle ---------------------------------------------------

    def on_submit(self, req, tick: int) -> None:
        """Start the request's async trace span and its TTFT clock."""
        self._submitted[req.rid] = (time.perf_counter(), tick)
        self._submitted_c.inc()
        self.trace.begin_async(
            "request", req.rid,
            args={"rid": str(req.rid), "priority": req.priority,
                  "arrival": req.arrival, "max_new": req.max_new})

    def on_reject(self, req) -> None:
        """Count a backpressure rejection."""
        self._rejected_c.inc()

    def on_admit(self, req, slot: int, tick: int) -> None:
        """Observe queue wait (ticks) and mark the admit in the trace."""
        sub = self._submitted.get(req.rid)
        wait = tick - max(req.arrival, sub[1]) if sub else 0
        self._queue_wait_h.observe(wait)
        self._prefill_c.inc()
        self.trace.instant("admit", tid=TID_REQUEST,
                           args={"rid": str(req.rid), "slot": slot,
                                 "queue_wait_ticks": wait})

    def on_first_token(self, req, tick: int) -> Optional[float]:
        """Returns the TTFT (seconds since submit); None if never seen."""
        sub = self._submitted.get(req.rid)
        if sub is None:
            return None
        ttft = time.perf_counter() - sub[0]
        self._ttft_h.observe(ttft)
        self.trace.instant("first_token", tid=TID_REQUEST,
                           args={"rid": str(req.rid),
                                 "ttft_ms": round(ttft * 1e3, 3)})
        return ttft

    def on_decode_tick(self, n_active: int, dur_s: float) -> None:
        """Update slot gauge/token counter; one TPOT sample per token."""
        self._active_g.set(n_active)
        self._tokens_c.inc(n_active)
        for _ in range(n_active):       # one TPOT observation per token
            self._tpot_h.observe(dur_s)

    def on_evict(self, comp) -> None:
        """Close the request's trace span and count the stop reason."""
        self.metrics.counter("serve_completed_total",
                             "completions by stop reason",
                             labels=self._labels({"reason": comp.reason})
                             ).inc()
        self._submitted.pop(comp.rid, None)
        self.trace.end_async(
            "request", comp.rid,
            args={"rid": str(comp.rid), "reason": comp.reason,
                  "slot": comp.slot, "n_tokens": len(comp.tokens),
                  "ticks": comp.finished_tick - comp.admitted_tick})

    def on_preempt(self, req, slot: int) -> None:
        """Drain evicted an in-flight request. Ends the async span (reason
        "preempt") so begin/end stay balanced — the router's requeue fires
        ``on_submit`` again, opening a fresh span and restarting the TTFT
        clock for the retried attempt."""
        self.metrics.counter("serve_preempted_total",
                             "in-flight requests evicted by replica drain",
                             labels=self._labels()).inc()
        self._submitted.pop(req.rid, None)
        self.trace.end_async("request", req.rid,
                             args={"rid": str(req.rid), "reason": "preempt",
                                   "slot": slot})

    # -- paging --------------------------------------------------------------

    def on_page_pool(self, in_use: int, n_pages: int) -> None:
        """Once per tick: page-pool occupancy gauge (capacity is static —
        exported once in the gauge's labels would be redundant; the serve
        bench row carries ``n_pages`` alongside the peak)."""
        self._pages_g.set(in_use)

    def on_prefix(self, matched: int, eligible: int) -> None:
        """Once per admission on prefix-sharing archs: ``matched`` of
        ``eligible`` prompt pages were served from the prefix cache."""
        if matched:
            self._prefix_hit_c.inc(matched)
        if eligible:
            self._prefix_query_c.inc(eligible)

    # -- tick phases ---------------------------------------------------------

    def phase(self, name: str):
        """Time one engine tick phase into both the per-phase latency
        histogram and a nested trace span."""
        hist = self.metrics.histogram("serve_tick_phase_seconds",
                                      "engine tick phase wall time",
                                      labels=self._labels({"phase": name}))
        return _PhaseTimer(self, name, hist)

    # -- compiles ------------------------------------------------------------

    def on_compile(self, event) -> None:
        """Record a CompileEvent: counter + wall-time histogram + an instant
        trace marker (the port has no FLOPs or bytes to record: no
        compiler estimates them)."""
        self.compile_events.append(event)
        labels = {"fn": event.name}
        self.metrics.counter("compile_total",
                             "first calls per shape key, per callable", labels=labels).inc()
        self.metrics.histogram("compile_seconds",
                               "wall time of a first call per shape key",
                               labels=labels).observe(event.wall_s)
        self.trace.instant("compile", args={
            "fn": event.name, "key": event.key,
            "wall_ms": round(event.wall_s * 1e3, 1)})

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """The obs/v1 document: metrics + trace summary + compile list."""
        return {"schema": SNAPSHOT_SCHEMA,
                "metrics": self.metrics.snapshot()["metrics"],
                "trace": self.trace.summary(),
                "compiles": [e.as_dict() for e in self.compile_events]}

    def export_metrics(self, path: str) -> str:
        """Write ``snapshot()`` as JSON; returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def export_trace(self, path: str) -> str:
        """Write the Chrome trace_event JSON (Perfetto); returns the path."""
        return self.trace.export(path)


class _PhaseTimer:
    """Context manager: one phase -> histogram observation + trace span
    (``TraceRecorder.span``, so a profiler range too while torch.profiler
    records). ``dur_s`` holds the measured duration after exit
    (the engine reuses the decode-phase duration as the tick's per-token
    TPOT)."""

    __slots__ = ("rec", "name", "hist", "dur_s", "_t0", "_span")

    def __init__(self, rec: EngineRecorder, name: str, hist):
        self.rec = rec
        self.name = name
        self.hist = hist
        self.dur_s = 0.0
        self._t0 = 0.0

    def __enter__(self):
        self._span = self.rec.trace.span(self.name, cat="tick")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur_s = time.perf_counter() - self._t0
        self.hist.observe(self.dur_s)
        return self._span.__exit__(*exc)
