"""Stdlib HTTP front end for the scoring service or a replica router (the
JAX package's ``serving/frontend.py``).

Handler threads only enqueue a request and wait on its future, or read a
snapshot; tokenization, packing and every device call stay on the
service's threads.

* ``POST /score`` with ``{"text": "...", "deadline_ms": 500, "tenant":
  "acme"}`` → the response; the tenant comes from the JSON field, else the
  ``X-MemVul-Tenant`` header, else the default tenant.  HTTP 200 ok, 503
  shed/drain, 504 deadline, 500 error, 400 for a malformed body.
* ``GET /healthz`` → ``health_summary()`` (a router's carries the fleet
  view), with the ``slo`` block of an attached SLO monitor and the
  ``tenancy`` block of an attached tenant manager; HTTP 200, or 503 once
  draining.
* ``GET /metrics`` → the live registries as Prometheus text
  (``telemetry/exposition.py``; a router labels each replica's part).
* ``GET /tracez[?limit=N]`` → the recent completed request traces, newest
  first.
* ``GET /programz`` → the program registry's rows, newest first (a router
  stamps each with its replica, a balancer with its host), the roofline,
  ``kernels``: this process's launch count of each hand-written
  kernel (``ops.*.launches``), which the JAX package has no counterpart
  of, and ``plain_on_card``: its plain-attention calls on the card that
  the routing kept off the kernel (``ops.plain_attention``);
* ``GET /metricsz[?window=S&metric=PREFIX]`` → the metrics history and
  ``GET /alertz`` → the alert rules and what fires, when the flight
  recorder is attached (``serving/incident.py``); else ``{"enabled":
  false, ...}`` (HTTP 200, so a probe tells "off" from a wrong path);
* ``POST /profilez`` with ``{"seconds": N}`` → starts a profiler capture
  into the run dir (``utils/profiling.ProfilerCapture``) and answers at
  once: HTTP 200 with its trace dir, 409 while a capture runs, 400 for a
  bad body, 503 when the server has no run dir.

The access log goes through ``logging``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry import get_registry
from ..telemetry.exposition import render_target
from ..utils.profiling import CaptureInProgress, ProfilerCapture
from .service import STATUS_DEADLINE, STATUS_DRAIN, STATUS_ERROR, STATUS_OK, STATUS_SHED, ScoringService

logger = logging.getLogger(__name__)

_HTTP_STATUS = {
    STATUS_OK: 200,
    STATUS_SHED: 503,
    STATUS_DRAIN: 503,
    STATUS_DEADLINE: 504,
    STATUS_ERROR: 500,
}
# how long past the request's deadline a handler waits on the future (the
# service resolves a deadline only at the pull)
_RESULT_SLACK_S = 30.0


def kernel_launches():
    """This process's launches of each hand-written kernel."""
    from ..ops import anchor_match, flash_attention, moe, plain_attention, ragged_attention

    return {"anchor_match": anchor_match.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_causal": flash_attention.causal_launches,
            "ragged_flash_attention": ragged_attention.launches,
            "plain_attention": plain_attention.launches,
            "grouped_gemm": moe.launches}


class ScoringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the service for its handlers;
    ``profile_dir`` arms ``POST /profilez``."""

    daemon_threads = True
    # the listen backlog (socketserver's default is 5): every request opens
    # a connection of its own, and a connect dropped from a full queue waits
    # out the kernel's 1 s SYN retransmit
    request_queue_size = 128

    def __init__(self, address, service: ScoringService, profile_dir=None):
        super().__init__(address, ScoreHandler)
        self.service = service
        self.profiler = ProfilerCapture(profile_dir) if profile_dir else None


class ScoreHandler(BaseHTTPRequestHandler):
    server_version = "memvul-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.info("%s %s", self.address_string(), format % args)

    def _reply(self, http_status: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(http_status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, http_status: int, text: str) -> None:
        body = text.encode("utf-8")
        self.send_response(http_status)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        path, _, query = self.path.partition("?")
        service = self.server.service
        if path == "/healthz":
            summary = service.health_summary()
            # attached monitors answer with a dict copy: a snapshot read
            monitor = getattr(service, "slo_monitor", None)
            if monitor is not None:
                summary["slo"] = monitor.status()
            scaler = getattr(service, "autoscaler", None)
            if scaler is not None:
                summary["autoscaler"] = scaler.status()
            manager = getattr(service, "tenant_manager", None)
            if manager is not None and "tenancy" not in summary:
                summary["tenancy"] = manager.summary()
            self._reply(503 if summary["draining"] else 200, summary)
            return
        if path == "/metrics":
            self._reply_text(200, render_target(service))
            return
        if path == "/tracez":
            params = urllib.parse.parse_qs(query)
            try:
                limit = int(params["limit"][0]) if "limit" in params else None
            except (TypeError, ValueError):
                self._reply(400, {"status": "error", "reason": "limit must be an integer"})
                return
            traces = service.recent_traces(limit)
            self._reply(200, {"count": len(traces), "traces": traces})
            return
        if path == "/programz":
            programs = service.programs_snapshot()
            from ..ops import plain_attention

            payload = {"count": len(programs), "programs": programs,
                       "kernels": kernel_launches(),
                       "plain_on_card": plain_attention.plain_on_card}
            roofline = getattr(service, "programs_roofline", None)
            if roofline is not None:
                payload["roofline"] = roofline()
            self._reply(200, payload)
            return
        if path == "/metricsz":
            params = urllib.parse.parse_qs(query)
            try:
                window_s = float(params["window"][0]) if "window" in params else None
            except (TypeError, ValueError):
                self._reply(400, {"status": "error", "reason": "window must be a number"})
                return
            metric = params["metric"][0] if "metric" in params else None
            sampler = getattr(service, "metrics_sampler", None)
            if sampler is None:
                self._reply(200, {"enabled": False, "series": 0, "history": {}})
                return
            payload = sampler.status()
            payload["history"] = sampler.history(window_s, metric)
            self._reply(200, payload)
            return
        if path == "/alertz":
            engine = getattr(service, "alert_engine", None)
            if engine is None:
                self._reply(200, {"enabled": False, "firing": [], "rules": []})
                return
            self._reply(200, engine.status())
            return
        self._reply(404, {"status": "error", "reason": "unknown path"})

    def _do_profilez(self) -> None:
        """Start a capture on the profiler's own thread and answer at once."""
        profiler = self.server.profiler
        if profiler is None:
            self._reply(503, {"status": "error", "reason": "profiling disabled: serve was "
                              "started without a run dir (-o/--out-dir)"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            seconds = float(payload["seconds"])
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"status": "error", "reason": f"bad request: {type(e).__name__}: "
                              f'{e} (expected {{"seconds": N}})'})
            return
        try:
            info = profiler.start(seconds)
        except CaptureInProgress as e:
            self._reply(409, {"status": "error", "reason": str(e)})
            return
        except ValueError as e:
            self._reply(400, {"status": "error", "reason": str(e)})
            return
        get_registry().counter("serve.profile_captures").inc()
        self._reply(200, {"status": "ok", **info})

    def do_POST(self) -> None:
        if self.path == "/profilez":
            self._do_profilez()
            return
        if self.path != "/score":
            self._reply(404, {"status": "error", "reason": "unknown path"})
            return
        service = self.server.service
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            text = payload["text"]
            if not isinstance(text, str):
                raise TypeError("'text' must be a string")
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            # the JSON field, then the header; neither: the default tenant
            tenant = payload.get("tenant") or self.headers.get("X-MemVul-Tenant")
            if tenant is not None and not isinstance(tenant, str):
                raise TypeError("'tenant' must be a string")
            # enqueue + wait on the future: the only service interaction
            future = service.submit(text, deadline_ms=deadline_ms, tenant=tenant)
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"status": "error", "reason": f"bad request: {type(e).__name__}: {e}"})
            return
        budget_ms = deadline_ms if deadline_ms and deadline_ms > 0 else service.default_deadline_ms
        try:
            response = future.result(timeout=_RESULT_SLACK_S + budget_ms / 1000.0)
        except TimeoutError:
            self._reply(504, {"status": "error", "reason": "request not resolved within the handler wait"})
            return
        self._reply(_HTTP_STATUS.get(response["status"], 500), response)


def run_http_server(service: ScoringService, host: str = "127.0.0.1", port: int = 0,
                    profile_dir=None) -> ScoringHTTPServer:
    """Bind (port 0 = ephemeral; read ``server.server_address``) and serve
    a service, a router or a balancer on a daemon thread; ``profile_dir``
    (the serve CLI passes its run dir) arms ``POST /profilez``.  Stop with
    ``server.shutdown()``, then ``service.drain()``."""
    server = ScoringHTTPServer((host, port), service, profile_dir=profile_dir)
    threading.Thread(target=server.serve_forever, name="memvul-serve-http", daemon=True).start()
    logger.info("scoring service listening on http://%s:%d (POST /score, GET /healthz, "
                "GET /metrics, GET /tracez, GET /programz, GET /metricsz, GET /alertz, "
                "POST /profilez)", *server.server_address[:2])
    return server
