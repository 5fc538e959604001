"""Non-dominated frontier over (accuracy, area, power, latency) (port of
``repro.tune.pareto``).

The autotuner's objective space is one maximized axis (deployed-forward
validation accuracy) against three minimized hardware axes from the
calibrated cost model. ``dominates`` is strict Pareto dominance (no worse
everywhere, strictly better somewhere) — irreflexive and transitive, which
tests/test_tune.py and tests/test_torch_tune.py pin on random point sets. ``ParetoFrontier`` is the
append-under-dominance set: a candidate that is weakly dominated by any
incumbent is rejected, and inserting a candidate evicts every incumbent it
weakly dominates, so a deliberately-dominated point can never survive.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from repro_torch.tune.space import OperatingPoint


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluated per-layer assignment with its objective vector.

    ``assignment`` holds one ``OperatingPoint`` per layer; ``accuracy`` is
    maximized, the three cost axes are minimized. ``meta`` carries
    non-compared bookkeeping (seeding tier, search round, extra metrics).
    """
    assignment: Tuple[OperatingPoint, ...]
    accuracy: float
    area_mm2: float
    power_w: float
    latency_ns: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                             compare=False)

    @property
    def sub8(self) -> bool:
        """True when any layer runs below 8 coefficient bits."""
        return any(pt.sub8 for pt in self.assignment)

    def objectives(self) -> Tuple[float, float, float, float]:
        """Uniformly-minimized objective vector (accuracy negated)."""
        return (-self.accuracy, self.area_mm2, self.power_w, self.latency_ns)

    def as_dict(self) -> Dict[str, Any]:
        """JSON row for the BENCH_pareto record."""
        return {
            "assignment": [pt.as_dict() for pt in self.assignment],
            "accuracy": self.accuracy,
            "area_mm2": self.area_mm2,
            "power_w": self.power_w,
            "latency_ns": self.latency_ns,
            "sub8": self.sub8,
            **{k: v for k, v in self.meta.items()},
        }


def _weakly_dominates(a: Candidate, b: Candidate) -> bool:
    return all(x <= y for x, y in zip(a.objectives(), b.objectives()))


def dominates(a: Candidate, b: Candidate) -> bool:
    """Strict Pareto dominance: ``a`` no worse than ``b`` on every
    objective and strictly better on at least one. Irreflexive (a point
    never dominates itself) and transitive."""
    return _weakly_dominates(a, b) and a.objectives() != b.objectives()


class ParetoFrontier:
    """Mutable non-dominated set of candidates."""

    def __init__(self):
        """Start empty; populate with ``add``."""
        self._points: List[Candidate] = []

    def __len__(self) -> int:
        """Number of non-dominated candidates currently held."""
        return len(self._points)

    def add(self, cand: Candidate) -> bool:
        """Insert ``cand`` if no incumbent weakly dominates it; evict every
        incumbent it weakly dominates. Returns True when inserted (i.e.
        ``cand`` is on the frontier afterwards)."""
        for p in self._points:
            if _weakly_dominates(p, cand):
                return False
        self._points = [p for p in self._points
                        if not _weakly_dominates(cand, p)]
        self._points.append(cand)
        return True

    def points(self) -> Tuple[Candidate, ...]:
        """Frontier candidates, best accuracy first (deterministic)."""
        return tuple(sorted(self._points,
                            key=lambda c: (-c.accuracy, c.area_mm2,
                                           c.power_w, c.latency_ns,
                                           c.assignment)))

    def dominated(self, cand: Candidate) -> bool:
        """True if some frontier point strictly dominates ``cand``."""
        return any(dominates(p, cand) for p in self._points)
