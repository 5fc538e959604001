"""SLO objectives + multi-window burn-rate alerting (stdlib-only).

A copy of ``repro.obs.slo``: the port imports nothing of ``repro``.

The fleet-health loop needs a *vocabulary* for "this replica is too slow",
not another histogram: an :class:`SLOObjective` says what fraction of
events must be good (``objective``) and what makes one good (latency under
``threshold``, or an event-level success bit); an :class:`SLOTracker`
scores events into per-tick buckets over a rolling window; and the alert
rule is the multi-window, multi-burn-rate construction from the Google SRE
workbook: alert only when the error budget burns faster than
``burn_factor`` x the sustainable rate over BOTH a long window (evidence
the problem is real) and a short window (evidence it is still happening) —
a long-past incident stops alerting as soon as the short window recovers,
and a one-tick blip never trips the long window.

Everything is measured in engine/router *ticks*, not wall seconds, so
breach traces are deterministic and the CI degraded-replica smoke is
reproducible. ``SLOMonitor`` bundles the four serving objectives the
router's ``HealthMonitor`` polls (TTFT p95, TPOT p99, queue-wait p95,
error/preempt rate) and renders the ``slo_verdicts`` column recorded in
results/BENCH_serve.json rows.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterable, Optional, Tuple

#: sentinel verdicts rendered into BENCH_serve rows / snapshots
VERDICT_OK = "ok"
VERDICT_BURNING = "burning"
VERDICT_NO_DATA = "no_data"


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One service-level objective.

    ``objective`` is the target good fraction (0.95 = "95% of TTFTs under
    threshold"); the error budget is ``1 - objective``. ``threshold`` is
    the per-event goodness bound for latency-style objectives (``observe``)
    and unused for event-style ones (``observe_event``). The alert rule
    fires when the budget burn rate exceeds ``burn_factor`` on both the
    ``long_window``- and ``short_window``-tick rolling windows."""
    name: str
    objective: float = 0.99
    threshold: Optional[float] = None
    long_window: int = 64
    short_window: int = 8
    burn_factor: float = 2.0
    min_events: int = 4      # long-window events required before alerting

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{self.objective}")
        if not (0 < self.short_window <= self.long_window):
            raise ValueError(
                f"need 0 < short_window <= long_window, got "
                f"{self.short_window} / {self.long_window}")

    @property
    def budget(self) -> float:
        """The error budget: allowed bad fraction, ``1 - objective``."""
        return 1.0 - self.objective


class SLOTracker:
    """Rolling good/bad accounting for ONE objective.

    Events scored during a tick accumulate in the current bucket;
    ``tick()`` closes it into a bounded deque of ``long_window`` per-tick
    ``(good, bad)`` pairs. ``burn_rate(w)`` is the bad fraction over the
    last ``w`` closed ticks divided by the error budget (1.0 = burning
    exactly at budget); ``breaching()`` applies the multi-window rule."""

    def __init__(self, slo: SLOObjective):
        self.slo = slo
        self._window: Deque[Tuple[int, int]] = collections.deque(
            maxlen=slo.long_window)
        self._cur_good = 0
        self._cur_bad = 0

    def observe(self, value: float) -> None:
        """Score a latency-style event: good iff ``value <= threshold``."""
        if self.slo.threshold is None:
            raise ValueError(f"SLO {self.slo.name!r} has no threshold; "
                             "use observe_event")
        self.observe_event(value <= self.slo.threshold)

    def observe_event(self, good: bool) -> None:
        """Score an event-style outcome (True = within SLO)."""
        if good:
            self._cur_good += 1
        else:
            self._cur_bad += 1

    def tick(self) -> None:
        """Close the current tick bucket into the rolling window."""
        self._window.append((self._cur_good, self._cur_bad))
        self._cur_good = 0
        self._cur_bad = 0

    def _counts(self, window: int) -> Tuple[int, int]:
        good = bad = 0
        for g, b in list(self._window)[-window:]:
            good += g
            bad += b
        return good, bad

    def burn_rate(self, window: int) -> Optional[float]:
        """Budget burn over the last ``window`` closed ticks: bad fraction
        divided by the error budget. None when the window saw no events
        (no traffic is not a breach)."""
        good, bad = self._counts(window)
        total = good + bad
        if total == 0:
            return None
        return (bad / total) / self.slo.budget

    def breaching(self) -> bool:
        """The multi-window multi-rate alert: burn > ``burn_factor`` on
        BOTH the long and short windows, with at least ``min_events``
        long-window events (a single early failure never pages)."""
        good, bad = self._counts(self.slo.long_window)
        if good + bad < self.slo.min_events:
            return False
        long_burn = self.burn_rate(self.slo.long_window)
        short_burn = self.burn_rate(self.slo.short_window)
        if long_burn is None or short_burn is None:
            return False
        return (long_burn > self.slo.burn_factor
                and short_burn > self.slo.burn_factor)

    def verdict(self) -> str:
        """``"burning"`` / ``"ok"`` / ``"no_data"`` for reports."""
        if self.breaching():
            return VERDICT_BURNING
        good, bad = self._counts(self.slo.long_window)
        return VERDICT_OK if good + bad else VERDICT_NO_DATA

    def summary(self) -> dict:
        """JSON-ready state: burns, verdict, and window totals."""
        good, bad = self._counts(self.slo.long_window)
        return {"objective": self.slo.objective,
                "threshold": self.slo.threshold,
                "burn_long": self.burn_rate(self.slo.long_window),
                "burn_short": self.burn_rate(self.slo.short_window),
                "events": good + bad, "bad": bad,
                "verdict": self.verdict()}


def default_serving_slos(*, ttft_s: float = 1.0, tpot_s: float = 0.5,
                         queue_wait_ticks: float = 32.0) -> Tuple[
                             SLOObjective, ...]:
    """The four serving objectives the router health loop watches: TTFT
    p95 (95% of first tokens under ``ttft_s``), TPOT p99, queue-wait p95
    (ticks), and a 99% error/preempt-free rate. Thresholds default to
    CPU-smoke-friendly bounds; production deployments pass their own."""
    return (
        SLOObjective("ttft", objective=0.95, threshold=ttft_s),
        SLOObjective("tpot", objective=0.99, threshold=tpot_s),
        SLOObjective("queue_wait", objective=0.95,
                     threshold=queue_wait_ticks),
        SLOObjective("errors", objective=0.99),
    )


class SLOMonitor:
    """A bundle of :class:`SLOTracker` s sharing one tick clock.

    ``observe(name, value)`` / ``observe_event(name, good)`` score events,
    ``tick()`` advances every tracker, ``breaching()`` names the burning
    objectives, and ``verdicts()`` is the ``{name: "ok" | "burning" |
    "no_data"}`` column shipped in BENCH_serve rows."""

    def __init__(self, slos: Optional[Iterable[SLOObjective]] = None):
        slos = tuple(slos) if slos is not None else default_serving_slos()
        self.trackers: Dict[str, SLOTracker] = {
            s.name: SLOTracker(s) for s in slos}

    def observe(self, name: str, value: float) -> None:
        """Score a latency event against the named objective."""
        self.trackers[name].observe(value)

    def observe_event(self, name: str, good: bool) -> None:
        """Score a success/failure event against the named objective."""
        self.trackers[name].observe_event(good)

    def tick(self) -> None:
        """Close the current tick bucket on every tracker."""
        for t in self.trackers.values():
            t.tick()

    def breaching(self) -> Tuple[str, ...]:
        """Names of the objectives currently burning (sorted)."""
        return tuple(sorted(n for n, t in self.trackers.items()
                            if t.breaching()))

    def verdicts(self) -> Dict[str, str]:
        """``{objective: verdict}`` — the BENCH_serve ``slo_verdicts``."""
        return {n: t.verdict() for n, t in sorted(self.trackers.items())}

    def summary(self) -> dict:
        """JSON-ready per-objective state (burn rates + verdicts)."""
        return {n: t.summary() for n, t in sorted(self.trackers.items())}
