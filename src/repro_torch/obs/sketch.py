"""Mergeable log-bucketed quantile sketch (DDSketch-style, stdlib-only).

A copy of ``repro.obs.sketch``: the port imports nothing of ``repro``.

``repro_torch.obs.metrics.Histogram`` answers percentile queries against a FIXED
bucket scheme chosen up front — good enough for one registry, but fleet
aggregation needs a structure whose buckets are defined by the *value*, not
by the registry that happened to observe it, so per-replica sketches merge
into one fleet sketch without losing the accuracy guarantee. This is the
DDSketch construction (Masson et al., VLDB 2019):

* **Relative-error guarantee.** For accuracy parameter ``alpha`` the bucket
  base is ``gamma = (1 + alpha) / (1 - alpha)`` and a positive value ``v``
  lands in bucket ``i = ceil(log_gamma(v))`` — i.e. bucket ``i`` covers
  ``(gamma**(i-1), gamma**i]``. Reporting the bucket midpoint
  ``2 * gamma**i / (gamma + 1)`` guarantees every quantile estimate ``q̂``
  satisfies ``|q̂ - q| <= alpha * q`` against the exact sample quantile
  ``q`` (rank-based, any rank in the bucket). The default ``alpha = 0.01``
  is a 1% relative-error bound — pinned by the property tests in
  tests/test_sketch_slo.py.
* **Mergeable.** Buckets are keyed by index, so ``merge`` is element-wise
  count addition: commutative, associative, and count-exact (the merged
  bucket counts, min/max and ranks equal those of sketching the
  concatenated stream; only the convenience ``sum`` can differ in final
  float bits from addition order). The router merges per-replica TTFT/TPOT
  sketches into one fleet snapshot this way.
* **Bounded memory.** At most ``max_bins`` buckets are kept; on overflow
  the lowest-index buckets collapse into the smallest retained one (the
  guarantee then holds for every value above the collapse boundary — at
  ``alpha = 0.01`` the default 2048 bins span > 17 orders of magnitude, so
  latencies never trigger a collapse in practice). ``collapsed`` counts how
  many times it happened.

Zero/negative values (a latency clock can report 0.0) are counted exactly
in ``zero_count`` / ``negative_count`` and participate in ranks; negative
magnitudes are not bucketed (latency sketches never see them, and the
guarantee is defined on positive values).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

#: default accuracy: 1% relative error on every quantile estimate
DEFAULT_ALPHA = 0.01

#: smallest positive value the sketch resolves; anything in [0, MIN_VALUE]
#: counts as zero (avoids unbounded negative bucket indices near 0.0)
MIN_VALUE = 1e-12

SKETCH_SCHEMA = "obs-sketch/v1"


class QuantileSketch:
    """DDSketch-style mergeable quantile sketch with relative-error bound
    ``alpha`` (see module docstring for the guarantee and memory bound)."""

    __slots__ = ("alpha", "gamma", "_log_gamma", "max_bins", "bins",
                 "zero_count", "negative_count", "count", "sum", "min",
                 "max", "collapsed")

    def __init__(self, alpha: float = DEFAULT_ALPHA, *, max_bins: int = 2048):
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_bins = int(max_bins)
        self.bins: Dict[int, int] = {}
        self.zero_count = 0
        self.negative_count = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.collapsed = 0

    # -- ingestion -----------------------------------------------------------

    def _index(self, v: float) -> int:
        """Bucket index of positive ``v``: ``ceil(log_gamma(v))`` — bucket
        ``i`` covers ``(gamma**(i-1), gamma**i]``."""
        return math.ceil(math.log(v) / self._log_gamma - 1e-11)

    def observe(self, v: float, n: int = 1) -> None:
        """Add ``n`` observations of value ``v`` (not-finite values are
        ignored, mirroring ``EngineStats._percentiles``)."""
        v = float(v)
        if not math.isfinite(v) or n <= 0:
            return
        self.count += n
        self.sum += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= MIN_VALUE:
            if v < 0.0:
                self.negative_count += n
            else:
                self.zero_count += n
            return
        i = self._index(v)
        self.bins[i] = self.bins.get(i, 0) + n
        if len(self.bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest-index buckets into the smallest retained one so
        at most ``max_bins`` remain (keeps the guarantee for the upper
        quantiles — the ones SLOs are written against)."""
        order = sorted(self.bins)
        floor = order[len(order) - self.max_bins]
        spill = 0
        for i in order:
            if i >= floor:
                break
            spill += self.bins.pop(i)
        if spill:
            self.bins[floor] = self.bins.get(floor, 0) + spill
            self.collapsed += 1

    # -- queries -------------------------------------------------------------

    def _bucket_value(self, i: int) -> float:
        """Midpoint estimate for bucket ``i`` — the point minimizing the
        worst-case relative error over ``(gamma**(i-1), gamma**i]``."""
        return 2.0 * self.gamma ** i / (self.gamma + 1.0)

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``q`` in [0, 1]); None when empty.
        Guaranteed within ``alpha`` relative error of the exact sample
        quantile (positive values; exact for the zero/negative mass)."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        # negative mass first (exact: reported as observed min), then the
        # zero mass, then the positive buckets in index order
        if rank < self.negative_count:
            return self.min
        if rank < self.negative_count + self.zero_count:
            return 0.0
        cum = self.negative_count + self.zero_count
        est = None
        for i in sorted(self.bins):
            cum += self.bins[i]
            if cum > rank:
                est = self._bucket_value(i)
                break
        if est is None:  # numeric edge: rank == count - 1 exactly
            est = self.max
        lo = self.min if self.min is not None else est
        hi = self.max if self.max is not None else est
        return min(max(est, lo), hi)

    def percentile(self, p: float) -> Optional[float]:
        """``quantile(p / 100)`` — the percentile-flavored accessor used by
        ``EngineStats.report()``'s sketch twins."""
        return self.quantile(p / 100.0)

    def percentiles(self) -> dict:
        """The ``{"p50", "p95", "p99", "n"}`` shape of
        ``EngineStats._percentiles``, plus the documented ``alpha`` bound —
        all None / n=0 when the sketch is empty."""
        out = {"p50": self.percentile(50), "p95": self.percentile(95),
               "p99": self.percentile(99), "n": self.count,
               "alpha": self.alpha}
        for k in ("p50", "p95", "p99"):
            if out[k] is not None:
                out[k] = round(out[k], 6)
        return out

    # -- merge ---------------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Pure merge: a NEW sketch whose bucket counts (and therefore
        every quantile estimate) equal sketching the concatenated streams;
        ``sum`` may differ in final float bits from addition order.
        Requires matching ``alpha`` (bucket bases must line up).
        Commutative and associative — pinned by tests/test_sketch_slo.py."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(f"cannot merge sketches with alpha "
                             f"{self.alpha} vs {other.alpha}")
        out = QuantileSketch(self.alpha,
                             max_bins=max(self.max_bins, other.max_bins))
        for src in (self, other):
            for i, c in src.bins.items():
                out.bins[i] = out.bins.get(i, 0) + c
            out.zero_count += src.zero_count
            out.negative_count += src.negative_count
            out.count += src.count
            out.sum += src.sum
            out.collapsed += src.collapsed
            for attr, pick in (("min", min), ("max", max)):
                v = getattr(src, attr)
                if v is not None:
                    cur = getattr(out, attr)
                    setattr(out, attr, v if cur is None else pick(cur, v))
        if len(out.bins) > out.max_bins:
            out._collapse()
        return out

    @staticmethod
    def merge_all(sketches: Iterable["QuantileSketch"]
                  ) -> Optional["QuantileSketch"]:
        """Fold ``merge`` over an iterable; None when it is empty. The
        router uses this to collapse per-replica sketches into the fleet
        snapshot."""
        out = None
        for s in sketches:
            out = s if out is None else out.merge(s)
        return out

    @classmethod
    def from_samples(cls, samples: Iterable[float],
                     alpha: float = DEFAULT_ALPHA, *,
                     max_bins: int = 2048) -> "QuantileSketch":
        """Sketch a finished sample list (what ``EngineStats`` holds).
        Observation order never matters — bucket counts are a multiset
        statistic — so sketching after the fact equals sketching online."""
        out = cls(alpha, max_bins=max_bins)
        for v in samples:
            out.observe(v)
        return out

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-ready encoding (schema ``obs-sketch/v1``): bins as sorted
        ``[index, count]`` pairs plus the exact side counters."""
        return {
            "schema": SKETCH_SCHEMA,
            "alpha": self.alpha,
            "max_bins": self.max_bins,
            "bins": sorted([int(i), int(c)] for i, c in self.bins.items()),
            "zero_count": self.zero_count,
            "negative_count": self.negative_count,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "collapsed": self.collapsed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        """Inverse of ``to_dict`` — round-trips bit-exactly, so replicas
        can ship sketches as JSON and the router can merge the decoded
        copies."""
        if d.get("schema") != SKETCH_SCHEMA:
            raise ValueError(f"not a {SKETCH_SCHEMA} document: "
                             f"{d.get('schema')!r}")
        out = cls(d["alpha"], max_bins=d["max_bins"])
        out.bins = {int(i): int(c) for i, c in d["bins"]}
        out.zero_count = int(d["zero_count"])
        out.negative_count = int(d["negative_count"])
        out.count = int(d["count"])
        out.sum = float(d["sum"])
        out.min = d["min"]
        out.max = d["max"]
        out.collapsed = int(d["collapsed"])
        return out

    def __len__(self) -> int:
        return len(self.bins)

    def __repr__(self) -> str:
        return (f"QuantileSketch(alpha={self.alpha}, n={self.count}, "
                f"bins={len(self.bins)})")
