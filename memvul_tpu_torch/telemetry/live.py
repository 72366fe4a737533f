"""Opt-in live exposition for runs that do not serve (the JAX package's
``telemetry/live.py``).

``telemetry.metrics_port`` (0 = off) starts this server on a daemon thread
inside ``train_from_config``, ``pretrain_from_config`` and the sharded
corpus scorer: the serving front end's Prometheus rendering over the
process-wide registries, so a long run is scrapeable while it runs.

* ``GET /metrics``  — the process registry's snapshot plus the
  ``program.*`` part, Prometheus text;
* ``GET /programz`` — the program registry's rows, newest first, and its
  roofline;
* ``GET /healthz``  — uptime and heartbeat age, the liveness probe;
* ``GET /metricsz`` / ``GET /alertz`` — the metrics history and the alert
  state when ``telemetry.tsdb_cadence_s`` > 0; ``{"enabled": false}``
  otherwise.

Every handler reads snapshots only.  With ``metrics_port`` 0 nothing here
is built.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from . import get_registry
from .exposition import SnapshotPart, render_exposition
from .programs import get_program_registry

logger = logging.getLogger(__name__)


def live_parts() -> List[SnapshotPart]:
    """The process-wide parts a live scrape renders: the telemetry
    registry's snapshot and, when a program is registered, the
    ``program.*`` part."""
    parts: List[SnapshotPart] = [({}, get_registry().snapshot())]
    program_part = get_program_registry().metrics_part()
    if program_part:
        parts.append(({}, program_part))
    return parts


class _LiveMetricsHandler(BaseHTTPRequestHandler):
    server_version = "memvul-telemetry/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("%s %s", self.address_string(), format % args)

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, payload) -> None:
        self._reply(status, json.dumps(payload, default=float).encode("utf-8"), "application/json")

    def do_GET(self) -> None:
        path, _, query = self.path.partition("?")
        server = self.server
        if path == "/metrics":
            text = render_exposition(server.parts())
            self._reply(200, text.encode("utf-8"), "text/plain; version=0.0.4")
            return
        if path == "/programz":
            programs = get_program_registry().snapshot()
            self._reply_json(200, {"count": len(programs), "programs": programs,
                                   "roofline": get_program_registry().roofline()})
            return
        if path == "/healthz":
            tel = get_registry()
            self._reply_json(200, {"status": "ok",
                                   "heartbeat_age_s": round(tel.heartbeat_age_s(), 3)})
            return
        if path == "/metricsz":
            params = urllib.parse.parse_qs(query)
            try:
                window_s = float(params["window"][0]) if "window" in params else None
            except (TypeError, ValueError):
                self._reply_json(400, {"status": "error", "reason": "window must be a number"})
                return
            metric = params["metric"][0] if "metric" in params else None
            sampler = server.sampler
            if sampler is None:
                self._reply_json(200, {"enabled": False, "series": 0, "history": {}})
                return
            payload = sampler.status()
            payload["history"] = sampler.history(window_s, metric)
            self._reply_json(200, payload)
            return
        if path == "/alertz":
            engine = server.engine
            if engine is None:
                self._reply_json(200, {"enabled": False, "firing": [], "rules": []})
                return
            self._reply_json(200, engine.status())
            return
        self._reply_json(404, {"status": "error", "reason": "unknown path"})


class LiveMetricsServer(ThreadingHTTPServer):
    """The daemon-thread exposition server.  ``close()`` is idempotent and
    stops the sampler and alert engine it was started with; the run's
    ``finally`` calls it, so a preempted run releases the port."""

    daemon_threads = True

    def __init__(self, address, sampler=None, engine=None,
                 parts: Optional[Callable[[], List[SnapshotPart]]] = None) -> None:
        super().__init__(address, _LiveMetricsHandler)
        self.sampler = sampler
        self.engine = engine
        self.parts = parts or live_parts
        self._thread = threading.Thread(target=self.serve_forever, name="memvul-metrics-http",
                                        daemon=True)
        self._closed = False

    def start(self) -> "LiveMetricsServer":
        self._thread.start()
        logger.info("live telemetry exposition on http://%s:%d (GET /metrics, /programz, "
                    "/healthz, /metricsz, /alertz)", *self.server_address[:2])
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.shutdown()
        self.server_close()
        for worker in (self.sampler, self.engine):
            if worker is not None:
                worker.stop()


def start_metrics_server(
    port: int,
    host: str = "127.0.0.1",
    sampler=None,
    engine: Optional[object] = None,
    parts: Optional[Callable[[], List[SnapshotPart]]] = None,
) -> LiveMetricsServer:
    """Bind and start the server (port 0 = ephemeral: read
    ``server.server_address``).  ``sampler`` and ``engine`` serve
    ``/metricsz`` and ``/alertz``; ``parts`` replaces the process-wide
    parts ``/metrics`` renders (the corpus scorer's coordinator passes its
    own registry's)."""
    return LiveMetricsServer((host, port), sampler=sampler, engine=engine, parts=parts).start()


def start_run_exposition(tel_cfg, parts=None) -> Optional[LiveMetricsServer]:
    """The run entry points' gate: with ``telemetry.metrics_port`` set,
    the server, and with ``telemetry.tsdb_cadence_s`` > 0 also a sampler
    of the same parts and the alert engine behind ``/metricsz`` and
    ``/alertz``; ``None`` (nothing built) with the port at 0."""
    port = int(tel_cfg.get("metrics_port") or 0)
    if not port:
        return None
    parts = parts or live_parts
    sampler = engine = None
    cadence = float(tel_cfg.get("tsdb_cadence_s") or 0.0)
    if cadence > 0:
        from .alerts import AlertEngine
        from .timeseries import MetricsSampler, TimeSeriesStore

        sampler = MetricsSampler(parts, store=TimeSeriesStore(
            resolution_s=float(tel_cfg["tsdb_resolution_s"]),
            retention_s=float(tel_cfg["tsdb_retention_s"])), cadence_s=cadence)
        engine = AlertEngine(sampler.store)
    return start_metrics_server(port, sampler=sampler, engine=engine, parts=parts)
