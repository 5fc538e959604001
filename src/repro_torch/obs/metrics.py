"""Process-local metrics registry: Counter / Gauge / Histogram.

A copy of ``repro.obs.metrics``: the port imports nothing of ``repro``.

Zero external dependencies (stdlib only) — the registry is the one place
every layer of the stack reports into, so importing it must never pull torch
or device state. Three metric kinds:

* ``Counter``   — monotonically increasing float (``inc``).
* ``Gauge``     — last-write-wins float (``set`` / ``inc``).
* ``Histogram`` — fixed-boundary bucketed observations. The default
  boundaries are **log-spaced latency buckets** (1 µs … 100 s, 3 per
  decade) so one scheme covers host bookkeeping (~µs), CPU-smoke decode
  ticks (~ms) and compile events (~s); ``percentile`` log-interpolates
  within the landing bucket and clamps to the observed min/max.

Metrics are identified by ``(name, labels)`` — ``labels`` is an optional
``dict`` (e.g. ``{"phase": "decode"}``) in the Prometheus style. The
registry hands back the *same* object for the same identity, so call sites
just ask for ``registry.counter("x")`` wherever they are.

Export paths:

* ``snapshot() -> dict``  — JSON-ready; ``{"schema": "obs-metrics/v1",
  "metrics": {series-key: {kind, ...}}}``. Histograms carry count / sum /
  min / max / cumulative ``buckets`` and precomputed p50/p95/p99.
* ``exposition() -> str`` — Prometheus text format (``# HELP``/``# TYPE``
  plus ``_bucket{le=...}``/``_sum``/``_count`` series) for scraping.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds from ``lo`` to >= ``hi``."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = math.ceil(per_decade * math.log10(hi / lo))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


#: 1 µs .. 100 s, 3 buckets per decade (25 bounds): one scheme for every
#: latency in the stack, from host bookkeeping to compile events.
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-6, 100.0, per_decade=3)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped (in that order — backslash first so
    the escapes themselves survive)."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    """``# HELP`` line escaping: backslash and newline (quotes are legal)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _format_value(v: float) -> str:
    """Render a sample value / ``le`` bound the way Prometheus parsers
    expect: ``+Inf`` / ``-Inf`` / ``NaN`` specials, shortest-repr floats
    otherwise (Go's strconv parses Python's repr output)."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def _label_suffix(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})

    @property
    def key(self) -> str:
        return self.name + _label_suffix(self.labels)


class Counter(Metric):
    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.key}: negative increment {v}")
        self.value += v

    def data(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def data(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labels)
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {buckets}")
        self.bounds = tuple(float(b) for b in buckets)
        # counts[i] = observations in (bounds[i-1], bounds[i]];
        # counts[-1] = overflow (> bounds[-1], the +Inf bucket)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                      # first bound >= v (bisect)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; log-interpolated within the landing bucket and
        clamped to the observed [min, max]. None when empty."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                if i >= len(self.bounds):       # overflow bucket
                    return self.max
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i else hi / 10.0
                frac = (target - (cum - c)) / c
                val = lo * (hi / lo) ** frac    # log interpolation
                return min(max(val, self.min), self.max)
        return self.max

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] ending with (+inf, count)."""
        out, cum = [], 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, self.count))
        return out

    def data(self) -> dict:
        return {
            "kind": self.kind, "count": self.count,
            "sum": round(self.sum, 9), "min": self.min, "max": self.max,
            "buckets": [[b if math.isfinite(b) else "+Inf", c]
                        for b, c in self.cumulative()],
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Process-local registry; same (name, labels) -> same metric object."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._kinds: Dict[str, str] = {}      # name -> kind (labels share)
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw) -> Metric:
        probe = cls(name, help, labels, **kw)
        with self._lock:
            existing = self._metrics.get(probe.key)
            if existing is not None:
                if existing.kind != cls.kind:
                    raise ValueError(
                        f"metric {probe.key!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            if self._kinds.setdefault(name, cls.kind) != cls.kind:
                raise ValueError(f"metric name {name!r} already used for a "
                                 f"{self._kinds[name]}")
            self._metrics[probe.key] = probe
            return probe

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[Metric]:
        return self._metrics.get(name + _label_suffix(labels or {}))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        with self._lock:
            return {"schema": "obs-metrics/v1",
                    "metrics": {m.key: m.data()
                                for m in self._metrics.values()}}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def exposition(self) -> str:
        """Prometheus text exposition format, conformant per the text-format
        spec: one ``# TYPE`` (and ``# HELP``, escaped) per metric name,
        histograms as CUMULATIVE ``_bucket`` series ending with
        ``le="+Inf"`` plus ``_sum``/``_count``, label values escaped
        (backslash / quote / newline), and ``+Inf``/``-Inf``/``NaN`` value
        specials — pinned by the conformance test in tests/test_obs.py."""
        lines: List[str] = []
        seen_header = set()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.key)
        for m in metrics:
            if m.name not in seen_header:
                seen_header.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for le, cum in m.cumulative():
                    lab = dict(m.labels)
                    lab["le"] = _format_value(le)
                    lines.append(f"{m.name}_bucket{_label_suffix(lab)} {cum}")
                suf = _label_suffix(m.labels)
                lines.append(f"{m.name}_sum{suf} {_format_value(m.sum)}")
                lines.append(f"{m.name}_count{suf} {m.count}")
            else:
                lines.append(f"{m.name}{_label_suffix(m.labels)} "
                             f"{_format_value(m.value)}")
        return "\n".join(lines) + "\n"
