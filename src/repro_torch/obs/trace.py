"""Span-based request/tick tracing with a bounded flight recorder, and the
scoring path's stage spans on the profiler's clock.

``TraceRecorder`` is a copy of ``repro.obs.trace``'s (the port imports
nothing of ``repro``), except that its spans also open a profiler range
of the same name while torch.profiler records: the engine's tick phases
then sit in the device trace, on its clock.

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

Stage spans (``stage(name)``) mark where ``kan.apply`` spends device time.
While torch.profiler records, a stage opens a profiler range (in the same
trace as the device operations) and, inside a call on the card, records a
CUDA event on the call's stream where the stage changes: a stage runs on
the device from its event to the next one, the call's end event closing
the last, so that a call's stages tile its device time, the idle inside
them included, and a stage that follows one of its own name (the bound
and the basis, the kernel and the readout scaling) adds no event. The
stages inside a call are siblings (``kan.apply`` is the only parent). The
events come from a pool that evicted calls give back to, since creating a
CUDA event under the profiler costs more host time than recording one.
With the profiler off a stage is one shared ``nullcontext``: no
allocation, no CUDA call. The ranges are ``record_function``'s C++ form
(``_RecordFunctionFast``, listed as ``cpu_op`` in a Chrome trace) where
torch has it: ~2 us of host a range on an H100's host where the Python
``record_function`` takes ~13, host time that would otherwise widen the
device's idle gaps the ranges are meant to name. ``stage(name, device)``
opens a call (``kan.apply``): the stages and counters inside it are kept
under it, the calls in a bounded ring (``StageRecorder``, most recent
kept, the rest counted in ``dropped``). ``stage_records(n)`` reads the
last ``n`` calls back, synchronizing once. The names, one layer's entries
summing where a stage repeats:

* ``kan.apply``   — the whole call (the only parent);
* ``kan.basis``   — the bound, input quantization, the SH-LUT lookup and
                    dense basis (on ``fused``, the bound alone);
* ``xbar.wl_dac`` — the word-line DAC (``quantize_wl``);
* ``xbar.gather`` — the gather into the chip's physical row order;
* ``kan.mac``     — the kernel call with its wrapper's conversions and the
                    readout scaling;
* ``kan.base``    — the base branch and its add;
* ``cf_kan.rank`` — the ranking to the top k (no call: a range only).

The counter of a call: ``xbar.rows_iterated``, the (batch row, word
line) pairs whose terms the crossbar kernels formed (a device counter they
add to, ``device_counter``). Calls run one at a time on the thread that
opened them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

TID_ENGINE = 0      # engine tick phases (nested spans)
TID_REQUEST = 1     # request lifecycle async events

_THREAD_NAMES = {TID_ENGINE: "engine ticks", TID_REQUEST: "requests"}

_NULL = contextlib.nullcontext()
_RANGE = None       # the range class, resolved on first use (``_range``)


def _range(name: str):
    """A profiler range ``name``: ``record_function``'s C++ form where this
    torch has it (a private name), else ``torch.profiler.record_function``."""
    global _RANGE
    if _RANGE is None:
        _RANGE = (getattr(getattr(torch._C, "_profiler", None),
                          "_RecordFunctionFast", None)
                  or torch.profiler.record_function)
    return _RANGE(name)


def profiler_range(name: str):
    """A profiler range ``name`` while torch.profiler records, else the
    shared null context."""
    if torch.autograd._profiler_enabled():
        return _range(name)
    return _NULL


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
            with profiler_range(name):
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


# ---------------------------------------------------------------------------
# Stage spans of the scoring path
# ---------------------------------------------------------------------------

class StageCall:
    """One call's record: the stage marks (none off the card), each stage
    running from its event to the next mark's, and the device counters."""

    __slots__ = ("device", "stream", "marks", "device_counts")

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = None          # the call's CUDA stream, once it opens
        self.marks: List[tuple] = []    # (name, event); name None: the end
        self.device_counts: Dict[str, List[torch.Tensor]] = {}


class _Stage:
    """A stage's range and mark; it opens ``call`` if given one."""

    __slots__ = ("rec", "name", "call", "opens", "rf")

    def __init__(self, rec: "StageRecorder", name: str,
                 call: Optional[StageCall], opens: bool):
        self.rec, self.name, self.call, self.opens = rec, name, call, opens

    def __enter__(self):
        # the range first: the host's time inside the call is the call's
        self.rf = _range(self.name)
        self.rf.__enter__()
        call = self.call
        if self.opens:
            if call.device.type == "cuda":
                call.stream = torch.cuda.current_stream(call.device)
            self.rec._open.append(call)
        elif call is not None and call.stream is not None and (
                not call.marks or call.marks[-1][0] != self.name):
            call.marks.append((self.name, self.rec._event(call)))
        return self

    def __exit__(self, *exc):
        if self.opens:
            call = self.call
            if call.marks:
                call.marks.append((None, self.rec._event(call)))
            self.rec._open.pop()
            self.rec.add(call)
        self.rf.__exit__(*exc)
        return False


class StageRecorder:
    """The ring of the last ``capacity`` calls' stage records, and the pool
    of CUDA events they reuse: an evicted call's events go back to it, and
    an empty pool is refilled ``POOL_CHUNK`` events at a time, each recorded
    once so that the CUDA event exists before a stage needs it (a batch of
    the benchmark's cells takes 7 to 11)."""

    POOL_CHUNK = 256

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._calls: collections.deque = collections.deque(maxlen=capacity)
        self._open: List[StageCall] = []
        self._pool: Dict[torch.device, list] = {}

    def __len__(self) -> int:
        return len(self._calls)

    def add(self, call: StageCall) -> None:
        if len(self._calls) == self.capacity:
            self.dropped += 1           # deque(maxlen) evicts the oldest
            old = self._calls[0]
            if old.marks:
                self._pool.setdefault(old.device, []).extend(
                    ev for _, ev in old.marks)
        self._calls.append(call)

    def _event(self, call: StageCall):
        """An event from the pool, recorded now on the call's stream."""
        pool = self._pool.setdefault(call.device, [])
        if not pool:
            for _ in range(self.POOL_CHUNK):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(call.stream)
                pool.append(ev)
        ev = pool.pop()
        ev.record(call.stream)
        return ev

    def stage(self, name: str, device: Optional[torch.device] = None):
        """The stage ``name`` (a new call on ``device`` if given and no call
        is open; inside one, a call is a range of it), or the shared null
        context while the profiler does not record."""
        if not torch.autograd._profiler_enabled():
            return _NULL
        if self._open:
            return _Stage(self, name, None if device is not None
                          else self._open[-1], False)
        if device is not None:
            return _Stage(self, name, StageCall(device), True)
        return _Stage(self, name, None, False)

    def device_counter(self, name: str) -> Optional[torch.Tensor]:
        """A zeroed int64 [1] tensor on the open call's card, kept under
        ``name`` in its record for a kernel to add to; None unless a call
        on the card records."""
        call = self._open[-1] if self._open else None
        if call is None or call.stream is None:
            return None
        t = torch.zeros(1, dtype=torch.int64, device=call.device)
        call.device_counts.setdefault(name, []).append(t)
        return t

    def records(self, n: int) -> List[Dict[str, float]]:
        """For each of the last ``n`` calls, oldest first: the device ms of
        each stage name, summed over the call's entries, and its device
        counters. Synchronizes each card the calls ran on, once."""
        calls = list(self._calls)[-n:] if n > 0 else []
        for dev in {c.device for c in calls if c.stream is not None}:
            torch.cuda.synchronize(dev)
        tensors = [t for c in calls for ts in c.device_counts.values()
                   for t in ts]
        values = iter(torch.cat(tensors).tolist() if tensors else ())
        out = []
        for c in calls:
            rec: Dict[str, float] = {}
            for (name, start), (_, end) in zip(c.marks, c.marks[1:]):
                rec[name] = rec.get(name, 0.0) + start.elapsed_time(end)
            for name, ts in c.device_counts.items():
                rec[name] = sum(next(values) for _ in ts)
            out.append(rec)
        return out


#: the process's stage ring, which the module-level functions use
STAGES = StageRecorder()


def stage(name: str, device: Optional[torch.device] = None):
    """``STAGES.stage``: a stage span (a call's, given its device)."""
    return STAGES.stage(name, device)


def device_counter(name: str) -> Optional[torch.Tensor]:
    """``STAGES.device_counter``."""
    return STAGES.device_counter(name)


def stage_records(n: int) -> List[Dict[str, float]]:
    """``STAGES.records``: the last ``n`` calls' stage ms and counters."""
    return STAGES.records(n)
