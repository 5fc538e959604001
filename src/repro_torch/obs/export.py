"""Live telemetry export: stdlib HTTP Prometheus endpoint + snapshot writer.

A copy of ``repro.obs.export``: the port imports nothing of ``repro``.

Everything else in ``repro_torch.obs`` produces *files* after the run; a fleet
needs the numbers while it is still serving. Two stdlib-only pieces:

* :class:`MetricsHTTPServer` — an ``http.server`` on a daemon thread
  exposing the live registry:

  - ``GET /metrics``       → Prometheus text exposition (scrape target)
  - ``GET /metrics.json``  → the ``obs/v1`` snapshot (or the bare registry
    snapshot when constructed from a plain ``MetricsRegistry``)

  Binding ``port=0`` picks an ephemeral port (``.port`` reports the real
  one) — the CI degraded-replica smoke starts the server, self-scrapes it,
  and asserts the scrape matches ``registry.exposition()``.

* :class:`PeriodicSnapshotWriter` — a daemon thread writing the ``obs/v1``
  JSON snapshot to a path every ``interval_s`` seconds (atomic
  replace-on-write, so a reader never sees a torn file); ``stop()`` writes
  one final snapshot, so the file always ends at the run's final state.

Both are wired through ``launch/serve.py --metrics-port`` /
``--snapshot-every``; both are stdlib only.
"""
from __future__ import annotations

import http.server
import json
import os
import threading
from typing import Optional


def _snapshot_of(source) -> dict:
    """The JSON document for ``/metrics.json``: an ``EngineRecorder``'s
    ``obs/v1`` snapshot when the source has one, else the bare registry
    snapshot (duck-typed — anything with ``snapshot()`` works)."""
    return source.snapshot()


def _registry_of(source):
    """The ``MetricsRegistry`` behind ``source``: the source itself when it
    exposes ``exposition()``, else its ``.metrics`` (an ``EngineRecorder``)."""
    if hasattr(source, "exposition"):
        return source
    return source.metrics


class MetricsHTTPServer:
    """Serve a live ``/metrics`` (Prometheus text) + ``/metrics.json``
    (JSON snapshot) endpoint for a ``MetricsRegistry`` or
    ``EngineRecorder`` on a background daemon thread."""

    def __init__(self, source, *, host: str = "127.0.0.1", port: int = 0):
        self.source = source
        self.host = host
        self._requested_port = port
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when constructed with 0)."""
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        """``http://host:port/metrics`` — the scrape target."""
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsHTTPServer":
        """Bind and start serving on a daemon thread; returns self."""
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            """Request handler closed over the metrics source."""

            def do_GET(self):  # noqa: N802 (http.server API)
                """Serve /metrics (text) and /metrics.json (snapshot)."""
                if self.path.split("?")[0] == "/metrics":
                    body = _registry_of(outer.source).exposition().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/metrics.json":
                    body = json.dumps(_snapshot_of(outer.source)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /metrics.json")
                    return
                outer.scrapes += 1
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                """Silence per-request stderr logging."""

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self._requested_port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-metrics-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down and join the serving thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        """Context-manager start."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Context-manager stop."""
        self.stop()


class PeriodicSnapshotWriter:
    """Write the source's JSON snapshot to ``path`` every ``interval_s``
    seconds on a daemon thread, atomically (write temp + ``os.replace``).
    ``stop()`` performs a final write, so the file always reflects the end
    state; ``writes`` counts snapshots taken."""

    def __init__(self, source, path: str, *, interval_s: float = 5.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.source = source
        self.path = path
        self.interval_s = float(interval_s)
        self.writes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> str:
        """Take one snapshot and atomically replace ``path``; returns the
        path."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_snapshot_of(self.source), f, indent=1)
        os.replace(tmp, self.path)
        self.writes += 1
        return self.path

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def start(self) -> "PeriodicSnapshotWriter":
        """Start the periodic writer thread; returns self."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-snapshot-writer")
        self._thread.start()
        return self

    def stop(self) -> str:
        """Stop the thread and write the final snapshot; returns the path."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        return self.write_once()

    def __enter__(self) -> "PeriodicSnapshotWriter":
        """Context-manager start."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Context-manager stop (writes the final snapshot)."""
        self.stop()
