"""Fault tolerance for long-running jobs: preemption + straggler detection.

A copy of ``repro.dist.fault``: the port imports nothing of ``repro``.

``PreemptionHandler`` turns SIGTERM/SIGINT (what schedulers send before
reclaiming a node) into a flag the train loop polls between steps, so the
loop can cut a final synchronous checkpoint and exit 0; the serving
router (``serve.router.Router.watch_preemption``) drains a replica on it.
``install=False`` skips signal registration for tests and non-main
threads; ``trigger()`` simulates a preemption either way.

``StepMonitor`` keeps a rolling window of step wall times and flags any step
slower than ``threshold`` x the window median as an ``Incident`` — the
cheap, host-side signal for stragglers, checkpoint stalls, or recompiles.
Incident steps are kept out of the window so one bad step does not inflate
the baseline it is judged against; but ``min_history`` *consecutive*
incidents are read as a legitimate regime change (curriculum seq-length
bump, post-resharding mesh), rebasing the window instead of alarming
forever.  ``incidents`` is a bounded ring (``max_incidents``) so
million-step jobs cannot grow it without limit.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import List, Optional


class PreemptionHandler:
    def __init__(self, install: bool = True,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        if install:
            for s in signals:
                self._prev[s] = signal.signal(s, self._on_signal)

    def _on_signal(self, signum, frame):
        self._stop = True

    def trigger(self) -> None:
        """Simulate a preemption (tests, admin-requested drain)."""
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def uninstall(self) -> None:
        """Restore the signal handlers that were replaced at install."""
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}


@dataclasses.dataclass(frozen=True)
class Incident:
    step: int
    duration: float
    median: float


class StepMonitor:
    def __init__(self, window: int = 20, threshold: float = 2.5,
                 min_history: int = 5, max_incidents: int = 256):
        self.window = window
        self.threshold = threshold
        self.min_history = min_history
        self.max_incidents = max_incidents
        self.times: List[float] = []
        self.incidents: List[Incident] = []
        self._step: Optional[int] = None
        self._t0: Optional[float] = None
        self._consecutive = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[Incident]:
        """Close the step opened by ``start_step``; returns an Incident if
        it was a straggler, else None."""
        if self._t0 is None:
            return None
        duration = time.perf_counter() - self._t0
        self._t0 = None
        incident = None
        if len(self.times) >= self.min_history:
            med = statistics.median(self.times)
            if med > 0 and duration > self.threshold * med:
                incident = Incident(self._step, duration, med)
                self.incidents.append(incident)
                if len(self.incidents) > self.max_incidents:
                    self.incidents.pop(0)
        if incident is None:        # stragglers don't poison the baseline
            self.times.append(duration)
            if len(self.times) > self.window:
                self.times.pop(0)
            self._consecutive = 0
        else:
            self._consecutive += 1
            if self._consecutive >= self.min_history:
                # sustained slowdown = new regime, not stragglers: rebase
                # on the new speed (alarms resume after a short warm-up)
                self.times = [i.duration for i in
                              self.incidents[-self._consecutive:]]
                del self.times[:-self.window]
                self._consecutive = 0
        return incident
