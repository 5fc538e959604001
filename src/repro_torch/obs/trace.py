"""Span-based request/tick tracing with a bounded flight recorder.

A copy of ``repro.obs.trace``: the port imports nothing of ``repro``.

``TraceRecorder`` collects Chrome ``trace_event`` dicts into a ring buffer
(``collections.deque(maxlen=capacity)``): a long-running engine keeps the
*most recent* window of activity and counts what it evicted
(``dropped``) instead of growing without bound — a flight recorder, not a
full log. ``chrome_trace()`` / ``export(path)`` emit the standard
``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
(https://ui.perfetto.dev) open directly.

Event vocabulary (all timestamps are µs since recorder construction):

* ``span(name)``             — context manager -> one complete ``"X"``
                               event (engine tick phases live here; spans
                               nest, Perfetto stacks them by thread).
* ``complete(name, ts, dur)``— the non-context-manager form of the same.
* ``instant(name)``          — ``"i"`` marker (admission, first token).
* ``begin_async / end_async``— ``"b"``/``"e"`` pairs keyed by ``id`` — the
                               request lifecycle (submit → … → evict) spans
                               many ticks and overlaps other requests, which
                               is exactly what async events model.

Threads are virtual lanes: ``TID_ENGINE`` holds the tick phase spans,
``TID_REQUEST`` the per-request lifecycle rows; ``chrome_trace()`` prepends
the ``M`` metadata events that name them in the viewer.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional

TID_ENGINE = 0      # engine tick phases (nested spans)
TID_REQUEST = 1     # request lifecycle async events

_THREAD_NAMES = {TID_ENGINE: "engine ticks", TID_REQUEST: "requests"}


class TraceRecorder:
    """Bounded Chrome-trace_event flight recorder."""

    def __init__(self, capacity: int = 65536, pid: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pid = os.getpid() if pid is None else pid
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- time ---------------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- event emission -----------------------------------------------------

    def _emit(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1           # deque(maxlen) evicts the oldest
        self._events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "engine", tid: int = TID_ENGINE,
                 args: Optional[dict] = None) -> None:
        ev = {"ph": "X", "name": name, "cat": cat, "ts": ts_us,
              "dur": dur_us, "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "engine", tid: int = TID_ENGINE,
             args: Optional[dict] = None):
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, self.now_us() - t0, cat=cat, tid=tid,
                          args=args)

    def instant(self, name: str, *, cat: str = "engine",
                tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "cat": cat, "ts": self.now_us(),
              "pid": self.pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def begin_async(self, name: str, id: object, *, cat: str = "request",
                    tid: int = TID_REQUEST,
                    args: Optional[dict] = None) -> None:
        ev = {"ph": "b", "name": name, "cat": cat, "id": str(id),
              "ts": self.now_us(), "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def end_async(self, name: str, id: object, *, cat: str = "request",
                  tid: int = TID_REQUEST,
                  args: Optional[dict] = None) -> None:
        ev = {"ph": "e", "name": name, "cat": cat, "id": str(id),
              "ts": self.now_us(), "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- export -------------------------------------------------------------

    def events(self) -> List[dict]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def chrome_trace(self) -> dict:
        meta = [{"ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
                 "args": {"name": "repro_torch.serve.engine"}}]
        for tid, name in _THREAD_NAMES.items():
            meta.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                         "tid": tid, "args": {"name": name}})
        # ring-truncation marker: a metadata event (not in the ring, so it
        # can never itself be evicted) tells a Perfetto session the view is
        # the most-recent window, with the eviction count inline — without
        # it, "otherData" is invisible in the UI and a truncated trace reads
        # as a complete one
        meta.append({"ph": "M", "name": "trace_truncation", "pid": self.pid,
                     "tid": TID_ENGINE,
                     "args": {"dropped_events": self.dropped,
                              "capacity": self.capacity}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def summary(self) -> Dict[str, float]:
        return {"events": len(self._events), "dropped": self.dropped,
                "capacity": self.capacity,
                "span_us": self.now_us()}
