"""Admission scheduling + accounting for the continuous-batching engine.

A copy of ``repro.serve.scheduler``: the port imports nothing of ``repro``.

The engine (repro_torch.serve.engine) owns a fixed pool of decode slots; this
module owns everything that happens before a request reaches a slot and the
bookkeeping of what happened afterwards:

* ``Request``      — one serving request (prompt tokens, budget, priority,
                     arrival tick, optional per-request EOS).
* ``AdmissionQueue`` — bounded FIFO-with-priority queue. Higher ``priority``
                     admits first; FIFO order breaks ties within a priority
                     class; ``submit`` returns False when the queue is full
                     (backpressure — callers must retry or shed load).
* ``Completion``   — the finished request: generated tokens + why it stopped.
* ``EngineStats``  — throughput/occupancy counters plus optional TTFT/TPOT
                     latency samples (filled when the engine runs with an
                     ``obs.EngineRecorder``); ``report()`` is the
                     machine-readable record benchmarks/bench_serve.py ships
                     to results/BENCH_serve.json.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.obs.sketch import QuantileSketch


@dataclasses.dataclass
class Request:
    """One serving request. ``arrival`` is the earliest engine tick at which
    the request may be admitted (staggered-arrival traces); ``priority``
    orders admission (higher first, FIFO within a class)."""
    rid: Any
    tokens: Any                       # 1-D int prompt
    max_new: int                      # total tokens to generate (incl. the
    #                                   token produced by prefill)
    priority: int = 0
    arrival: int = 0
    eos_id: Optional[int] = None
    frames: Any = None                # enc-dec only: encoder features [S, D]


@dataclasses.dataclass
class Completion:
    """A finished request as handed back by ``Engine.run``/``step``:
    the generated tokens, the stop reason ("eos" early stop vs "length"
    budget exhaustion), and the slot/tick coordinates that place it in the
    obs trace."""
    rid: Any
    tokens: np.ndarray                # [n_generated]
    reason: str                       # "eos" | "length"
    slot: int
    admitted_tick: int
    finished_tick: int


class AdmissionQueue:
    """Bounded priority queue: higher ``Request.priority`` pops first, FIFO
    within a priority class, and only requests whose ``arrival`` tick has
    passed are eligible. ``submit`` returns False when ``max_pending`` is
    reached — the engine surfaces that as backpressure, never silent drops.

    Arrival-partitioned heap implementation: not-yet-arrived requests wait
    in a min-heap on ``(arrival, seq)``; once their tick passes they move to
    the ready heap keyed ``(-priority, seq)``, so ``pop`` is O(log n) per
    moved/popped item instead of the previous O(n) scan-and-remove. The
    submission counter ``seq`` is global, so FIFO order within a priority
    class is preserved across the future->ready migration (a request
    submitted earlier but arriving later still pops first among equals once
    both are eligible — identical to the old list implementation, pinned by
    the property test in tests/test_obs.py)."""

    def __init__(self, max_pending: Optional[int] = None):
        self.max_pending = max_pending
        self._ready: List[Tuple[Tuple[int, int], Request]] = []
        self._future: List[Tuple[int, int, Request]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._ready) + len(self._future)

    def submit(self, req: Request, *, force: bool = False) -> bool:
        """Enqueue a request. False (nothing enqueued) when the queue is at
        ``max_pending`` — the backpressure signal callers must handle.
        ``force=True`` bypasses the bound: the router uses it when
        requeueing preempted in-flight requests from a draining replica,
        where refusing would *lose* an already-accepted request (integrity
        beats backpressure for work the system has committed to)."""
        if (not force and self.max_pending is not None
                and len(self) >= self.max_pending):
            return False
        seq = next(self._seq)
        heapq.heappush(self._future, (req.arrival, seq, req))
        return True

    def _migrate(self, tick: int) -> None:
        while self._future and self._future[0][0] <= tick:
            arrival, seq, req = heapq.heappop(self._future)
            heapq.heappush(self._ready, ((-req.priority, seq), req))

    def pop(self, tick: int) -> Optional[Request]:
        """Highest-priority (FIFO-within-class) request with arrival <= tick."""
        self._migrate(tick)
        if not self._ready:
            return None
        return heapq.heappop(self._ready)[1]

    def peek(self, tick: int) -> Optional[Request]:
        """The request ``pop(tick)`` would return, without removing it.

        The engine peeks to run page-admission checks (reserve worst-case
        page demand, claim prefix pages) *before* committing to dequeue:
        when the pool can't cover the head request, it stays queued with
        its FIFO position intact instead of being popped and re-submitted
        with a new sequence number."""
        self._migrate(tick)
        if not self._ready:
            return None
        return self._ready[0][1]

    def next_arrival(self) -> Optional[int]:
        """Earliest arrival tick among pending requests (None when empty)."""
        candidates = [req.arrival for _, req in self._ready]
        if self._future:
            candidates.append(self._future[0][0])
        return min(candidates, default=None)

    def drain(self) -> List[Request]:
        """Remove and return every queued request in pop order: ready
        requests by ``(-priority, seq)``, then not-yet-arrived ones by
        ``(arrival, seq)``. The router drains a removed replica's local
        backlog through this and resubmits it to the global queue; the
        returned requests keep their original arrival ticks."""
        out = [heapq.heappop(self._ready)[1] for _ in range(len(self._ready))]
        while self._future:
            out.append(heapq.heappop(self._future)[2])
        return out


#: the explicit zero-sample latency shape: every percentile is None (JSON
#: null), never NaN — ``json.dumps(..., allow_nan=False)`` stays valid and
#: records_check's latency gates can tell "unrecorded" from "broken"
EMPTY_PERCENTILES = {"p50": None, "p95": None, "p99": None, "n": 0}


@dataclasses.dataclass
class EngineStats:
    """Throughput/occupancy accounting. ``occupancy_ticks`` sums the number
    of active slots over decode ticks, so mean occupancy = occupancy_ticks /
    (decode_ticks * n_slots); ``slot_served[i]`` counts requests admitted to
    slot i — any value > 1 proves slot reuse (eviction + readmission).
    ``ff_ticks`` counts idle ticks the engine *skipped* by fast-forwarding
    to the next arrival (they are also included in ``idle_ticks`` and
    ``ticks``, so occupancy math is unchanged). ``ttft_s`` / ``tpot_s`` are
    per-request / per-token wall-latency samples, only collected when the
    engine runs with a recording ``obs`` recorder.

    Paging counters (filled by the paged engine): ``pages_in_use_peak`` is
    the high-water mark of live KV pages; ``prefill_chunks`` counts
    chunked-prefill device calls; ``prefix_hit_pages`` /
    ``prefix_eligible_pages`` count prompt pages served from the prefix
    cache vs. prompt pages that were *candidates* for matching (their
    ratio is the ``prefix_hit_rate`` in ``report()``)."""
    n_slots: int
    ticks: int = 0                    # total ticks (decode + idle)
    idle_ticks: int = 0               # ticks with no active slot
    ff_ticks: int = 0                 # idle ticks skipped via fast-forward
    prefills: int = 0
    decode_tokens: int = 0
    completed: int = 0
    evicted_eos: int = 0
    evicted_length: int = 0
    rejected: int = 0                 # backpressure / over-length rejections
    preempted: int = 0                # in-flight requests evicted by drain
    occupancy_ticks: int = 0
    slot_served: List[int] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    tpot_s: List[float] = dataclasses.field(default_factory=list)
    page_size: int = 0                # KV page size (tokens)
    n_pages: int = 0                  # pool capacity incl. the garbage page
    pages_in_use_peak: int = 0        # high-water mark of live pages
    prefill_chunks: int = 0           # chunked-prefill device calls
    prefix_hit_pages: int = 0         # prompt pages reused from the cache
    prefix_eligible_pages: int = 0    # prompt pages that could have matched

    def __post_init__(self):
        if not self.slot_served:
            self.slot_served = [0] * self.n_slots

    @property
    def decode_ticks(self) -> int:
        """Ticks that ran the fused decode step (total minus idle)."""
        return self.ticks - self.idle_ticks

    def mean_occupancy(self) -> float:
        """Mean fraction of slots active over the decode ticks (0..1];
        0.0 for a zero-slot stats shell (router aggregates) — never a
        ZeroDivisionError."""
        denom = max(self.decode_ticks, 1) * self.n_slots
        return self.occupancy_ticks / denom if denom else 0.0

    @staticmethod
    def _percentiles(samples: List[float]) -> dict:
        """p50/p95/p99 over the *finite* samples; a copy of
        ``EMPTY_PERCENTILES`` when none survive (zero admitted requests, or
        a clock hiccup injected NaN/inf) — the empty shape is explicit and
        JSON-clean rather than NaN percentiles of an empty array."""
        arr = np.asarray(samples, dtype=np.float64)
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return dict(EMPTY_PERCENTILES)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {"p50": round(float(p50), 6), "p95": round(float(p95), 6),
                "p99": round(float(p99), 6), "n": int(arr.size)}

    def latency_report(self) -> dict:
        """p50/p95/p99 TTFT + TPOT (seconds) from the recorded samples;
        the ``EMPTY_PERCENTILES`` shape (all None) when the engine ran
        unrecorded or admitted nothing."""
        return {"ttft": self._percentiles(self.ttft_s),
                "tpot": self._percentiles(self.tpot_s)}

    def latency_sketches(self) -> Tuple[QuantileSketch, QuantileSketch]:
        """(TTFT, TPOT) ``QuantileSketch``es over the recorded samples.

        Built lazily at report time — sketch bucket counts are a multiset
        statistic, so sketching the finished sample list is identical to
        having observed online, and the engine hot path stays untouched.
        These are what ``Router.report`` merges into the fleet snapshot."""
        return (QuantileSketch.from_samples(
                    v for v in self.ttft_s if np.isfinite(v)),
                QuantileSketch.from_samples(
                    v for v in self.tpot_s if np.isfinite(v)))

    def report(self) -> dict:
        """Machine-readable run summary: throughput, occupancy, eviction
        accounting, latency percentiles, and the paging/prefix-cache
        columns. This is the dict bench_serve rows are built from, so its
        keys are part of the BENCH_serve.json schema that
        benchmarks/records_check.py gates on."""
        wall = self.wall_s or float("nan")
        lat = self.latency_report()
        ttft_sk, tpot_sk = self.latency_sketches()
        return {
            "n_slots": self.n_slots,
            "ticks": self.ticks,
            "idle_ticks": self.idle_ticks,
            "ff_ticks": self.ff_ticks,
            "prefills": self.prefills,
            "decode_tokens": self.decode_tokens,
            "completed": self.completed,
            "evicted_eos": self.evicted_eos,
            "evicted_length": self.evicted_length,
            "rejected": self.rejected,
            "preempted": self.preempted,
            "mean_occupancy": round(self.mean_occupancy(), 4),
            "slot_served": list(self.slot_served),
            "slot_reuse": max(self.slot_served, default=0),
            "wall_s": round(self.wall_s, 4),
            "requests_per_s": round(self.completed / wall, 3)
            if self.wall_s else None,
            "tokens_per_s": round(
                (self.decode_tokens + self.prefills) / wall, 2)
            if self.wall_s else None,
            "ttft_s": lat["ttft"],
            "tpot_s": lat["tpot"],
            # sketch-derived twins of the numpy percentiles above: same
            # samples through the mergeable QuantileSketch (alpha-bounded
            # relative error) — cross-checked against the exact fields in
            # tests/test_obs.py, merged fleet-wide by Router.report()
            "ttft_sketch": ttft_sk.percentiles(),
            "tpot_sketch": tpot_sk.percentiles(),
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pages_in_use_peak": self.pages_in_use_peak,
            "prefill_chunks": self.prefill_chunks,
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefix_eligible_pages": self.prefix_eligible_pages,
            "prefix_hit_rate": round(
                self.prefix_hit_pages / self.prefix_eligible_pages, 4)
            if self.prefix_eligible_pages else 0.0,
        }
