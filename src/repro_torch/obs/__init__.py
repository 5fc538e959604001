"""repro_torch.obs — observability for the serving/kernel/chip stack (port
of ``repro.obs``; every module but ``profile`` is a copy).

Zero-dependency telemetry in three parts, tied together by a recorder:

* ``metrics``  — process-local Counter/Gauge/Histogram registry with
                 log-spaced latency buckets, JSON ``snapshot()`` and
                 Prometheus text ``exposition()``.
* ``trace``    — span-based flight recorder (bounded ring buffer) that
                 exports Chrome ``trace_event`` JSON for Perfetto, and the
                 scoring path's stage spans on torch.profiler's clock.
* ``profile``  — call wrappers that record the first call per distinct
                 argument-shape key (the twin of the reference's compile
                 events; PyTorch compiles nothing).

``recorder.EngineRecorder`` is what you hand to ``serve.engine.Engine``;
the default ``NullRecorder`` keeps the hot path untouched.

Fleet-health additions (all stdlib-only):

* ``sketch``   — mergeable DDSketch-style quantile sketch with a 1%
                 relative-error guarantee; per-replica latency sketches
                 merge into one fleet snapshot.
* ``slo``      — SLO objectives over rolling tick windows with
                 multi-window burn-rate alerts (``SLOMonitor``).
* ``export``   — live ``http.server`` Prometheus endpoint
                 (``MetricsHTTPServer``) + periodic JSON snapshots
                 (``PeriodicSnapshotWriter``).

Note: every module here but ``trace`` (which opens torch.profiler ranges)
is stdlib-only. ``profile`` is not re-exported, as in the reference:
import ``repro_torch.obs.profile`` directly.
"""
from repro_torch.obs.export import (  # noqa: F401
    MetricsHTTPServer, PeriodicSnapshotWriter)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, DEFAULT_LATENCY_BUCKETS, Gauge, Histogram, MetricsRegistry,
    log_buckets)
from repro_torch.obs.recorder import (  # noqa: F401
    EngineRecorder, NullRecorder, SNAPSHOT_SCHEMA)
from repro_torch.obs.sketch import DEFAULT_ALPHA, QuantileSketch  # noqa: F401
from repro_torch.obs.slo import (  # noqa: F401
    SLOMonitor, SLOObjective, SLOTracker, default_serving_slos)
from repro_torch.obs.trace import TraceRecorder  # noqa: F401

__all__ = [
    "Counter", "DEFAULT_ALPHA", "DEFAULT_LATENCY_BUCKETS", "EngineRecorder",
    "Gauge", "Histogram", "MetricsHTTPServer", "MetricsRegistry",
    "NullRecorder", "PeriodicSnapshotWriter", "QuantileSketch",
    "SLOMonitor", "SLOObjective", "SLOTracker", "SNAPSHOT_SCHEMA",
    "TraceRecorder", "default_serving_slos", "log_buckets",
]
