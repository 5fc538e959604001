"""The traced part of a ``--trace 1`` run: ``torch.profiler``'s trace of a
few batches, reduced to what the per-layer readers need.

The benchmark places its own ranges (``record_function``) around each batch
and around its calls into the program's layers (``SPANS``); on the LM cells
around each engine step (``ENGINE_STEP``) and the reference's forward
passes (``LM_REFERENCE``, after the window: never traced). A device
operation belongs to a range when the host call that launched it falls
inside the range. Kernels that the program launches through its own
library (``ctypes``) come with no host call in the trace; the batches run
one at a time on one stream, so such a kernel is given the launch time of
the operation before it in the same batch (or, where it comes first, of the
one after it).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

BATCH = "kanbench.batch"
SPANS = ("kanbench.kan_apply", "kanbench.rank")
ENGINE_STEP = "kanbench.engine_step"
LM_REFERENCE = "kanbench.lm_reference"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH = {"cuda_runtime", "cuda_driver"}
_HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
         "python_function"}


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float            # µs, on the trace's clock
    end: float
    spans: Tuple[str, ...]  # the benchmark's ranges it belongs to


@dataclasses.dataclass
class Trace:
    """Device operations of the traced batches, by the ranges they ran in."""
    ops: List[DeviceOp]
    window: Tuple[float, float]       # first batch's (step's) start, last
    #                                   one's end
    span_counts: Dict[str, int]       # instances of each range
    host: List[Tuple[float, float, str]]  # host events, for the idle gaps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        total, reach = 0.0, self.window[0]
        for op in sorted(self.ops, key=lambda o: o.start):
            lo, hi = max(op.start, reach), min(op.end, self.window[1])
            if hi > lo:
                total += hi - lo
                reach = hi
        return total / 1e6

    def device_s(self, span: Optional[str] = None,
                 kernel: Optional[str] = None) -> float:
        """Device seconds of the operations in range ``span`` (any, if None)
        whose name matches the regular expression ``kernel`` (any, if
        None)."""
        pat = re.compile(kernel) if kernel else None
        return sum(op.end - op.start for op in self.ops
                   if (span is None or span in op.spans)
                   and (pat is None or pat.search(op.name))) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, by short name."""
        by = {}
        for op in self.ops:
            short = re.split(r"[<(]", re.sub(
                r"^void |\(anonymous namespace\)::", "", op.name))[0][:80]
            by[short] = by.get(short, 0.0) + (op.end - op.start) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time in the window, by the innermost host event
        under way at the middle of each gap, longest first."""
        by, reach = {}, self.window[0]
        edges = sorted(self.ops, key=lambda o: o.start)
        gaps = []
        for op in edges + [None]:
            nxt = self.window[1] if op is None else min(op.start,
                                                         self.window[1])
            if nxt > reach:
                gaps.append((reach, nxt))
            if op is not None:
                reach = max(reach, op.end)
        # one sweep over the host events by start: a heap of those begun,
        # shortest first, drops each that ended before the gap's middle
        host, k, live = sorted(self.host), 0, []
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            while k < len(host) and host[k][0] <= mid:
                s, e, name = host[k]
                heapq.heappush(live, (e - s, name, e))
                k += 1
            while live and live[0][2] < mid:
                heapq.heappop(live)
            name = live[0][1] if live else "no host event"
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def read(prof, outer: str = BATCH, spans: Tuple[str, ...] = SPANS
         ) -> Trace:
    """Reduce a stopped ``torch.profiler.profile`` to a ``Trace`` (through
    its Chrome trace, written to and read back from a temporary file):
    ``outer`` is the range of one batch (or engine step), ``spans`` the
    ranges inside it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events, outer, spans)


def reduce(events: List[Dict], outer: str = BATCH,
           spans_in: Tuple[str, ...] = SPANS) -> Trace:
    """A ``Trace`` from Chrome trace events."""
    spans: Dict[str, List[Tuple[float, float]]] = {}
    launches, device, host = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE:
            device.append((ts, end, e["name"], corr))
        if cat in _LAUNCH and corr is not None:
            launches[corr] = ts
        if cat == "user_annotation" and e["name"] in (outer,) + spans_in:
            spans.setdefault(e["name"], []).append((ts, end))
        if cat in _HOST:
            host.append((ts, end, e["name"]))
    batches = sorted(spans.get(outer, []))
    if not batches:
        return Trace([], (0.0, 0.0), {}, [])
    window = (batches[0][0], batches[-1][1])
    starts = [b[0] for b in batches]
    per_batch: Dict[int, List] = {}
    for ts, end, name, corr in sorted(device):
        j = bisect.bisect_right(starts, ts) - 1
        if j < 0 or ts > batches[j][1]:
            continue
        per_batch.setdefault(j, []).append([ts, end, name, launches.get(corr)])
    for ops in per_batch.values():
        _fill_launches(ops)
    ops = []
    for ops_j in per_batch.values():
        for ts, end, name, at in ops_j:
            inside = tuple(s for s in spans_in if at is not None and any(
                a <= at <= b for a, b in spans.get(s, [])))
            ops.append(DeviceOp(name, ts, end, (outer,) + inside))
    counts = {name: len(v) for name, v in spans.items()}
    host = [h for h in host if h[1] >= window[0] and h[0] <= window[1]]
    return Trace(ops, window, counts, host)


def _fill_launches(ops: List[List]) -> None:
    """Give each operation with no launch the launch time of the operation
    before it (in device order), else of the one after it."""
    last = None
    for op in ops:
        if op[3] is None:
            op[3] = last
        else:
            last = op[3]
    nxt = None
    for op in reversed(ops):
        if op[3] is None:
            op[3] = nxt
        else:
            nxt = op[3]
