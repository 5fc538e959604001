"""Profiling hooks for the engine's device calls: first-call events per
shape key (port of ``repro.obs.profile``).

The JAX engine compiles one prefill executable per distinct prompt length
and one fused decode tick, and its ``JitProfiler`` makes those compiles
visible. PyTorch runs eagerly: there is nothing to lower or compile. The
twin keeps the same vocabulary so that a recorder, a snapshot and the
tests read the same: ``JitProfiler`` wraps a plain callable and, the first
time it is called with a distinct argument-shape key (``shape_key``),
records a :class:`CompileEvent` whose ``wall_s`` is that first call's wall
time. On the card the call returns once its work is queued, so ``wall_s``
is host time (launches, and the kernels' build on the very first call of
a process), not device time. ``flops`` and ``bytes_accessed`` stay
``None``, which is what the reference records when XLA has no cost
analysis.

Events flow into a recorder (anything with ``on_compile(event)``, see
``repro_torch.obs.recorder``).

The engine wraps its callables only when a recorder is enabled; the
default ``NullRecorder`` path never sees this module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """The first call of a profiled callable for one shape key."""
    name: str                 # callable name ("prefill", "decode_tick", ...)
    key: str                  # human-readable arg-shape key
    wall_s: float             # wall seconds of that first call
    flops: Optional[float]    # always None in the port (no cost analysis)
    bytes_accessed: Optional[float]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _leaves(tree) -> List[Any]:
    """Leaves of nested dicts, lists, tuples and dataclasses (a deployed
    KAN artifact is a dataclass)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


def shape_key(args: Tuple[Any, ...]) -> str:
    """Stable key for the arg shapes/dtypes. A Python number is keyed by
    its type only: the port passes offsets and slots as host integers
    where the reference passes traced scalars, which do not re-key a
    compile either."""
    parts = []
    for leaf in _leaves(args):
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            parts.append(f"{getattr(leaf, 'dtype', '?')}{list(shape)}")
        elif isinstance(leaf, (bool, int, float)):
            parts.append(type(leaf).__name__)
        else:
            parts.append(repr(leaf))
    return ",".join(parts)


class JitProfiler:
    """Wrap a callable; record its first call per shape key."""

    def __init__(self, fn, name: str, recorder):
        # re-wrapping a profiler (``Engine.adopt_compiled``) shares its
        # record of the shape keys seen: the adopting engine logs no first
        # call for a shape the other engine already ran
        if isinstance(fn, JitProfiler):
            self._seen = fn._seen
            fn = fn.fn
        else:
            self._seen: Dict[str, bool] = {}
        self.fn = fn
        self.name = name
        self.recorder = recorder
        self.events: List[CompileEvent] = []

    def __call__(self, *args):
        key = shape_key(args)
        if key in self._seen:
            return self.fn(*args)
        t0 = time.perf_counter()
        out = self.fn(*args)
        event = CompileEvent(name=self.name, key=key,
                             wall_s=time.perf_counter() - t0, flops=None,
                             bytes_accessed=None)
        self._seen[key] = True
        self.events.append(event)
        if self.recorder is not None:
            self.recorder.on_compile(event)
        return out

    @property
    def n_compiles(self) -> int:
        return len(self.events)


def maybe_profile(fn, name: str, recorder):
    """Wrap ``fn`` in a JitProfiler when ``recorder`` is enabled; otherwise
    return it untouched (the disabled hot path stays as it is)."""
    if recorder is None or not getattr(recorder, "enabled", False):
        return fn
    return JitProfiler(fn, name, recorder)

