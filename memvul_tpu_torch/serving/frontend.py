"""Stdlib HTTP front end for the scoring service (the JAX package's
``serving/frontend.py``: ``POST /score`` and ``GET /healthz``).

Handler threads only enqueue a request and wait on its future;
tokenization, packing and every device call stay on the service's
threads.

* ``POST /score`` with ``{"text": "...", "deadline_ms": 500}`` → the
  service response; HTTP 200 ok, 503 shed/drain, 504 deadline, 500 error,
  400 for a malformed body or a named tenant.
* ``GET /healthz`` → ``health_summary()``; HTTP 200, or 503 once draining.

``/metrics``, ``/tracez``, ``/programz``, ``/metricsz``, ``/alertz`` and
``/profilez`` wait for the ops-plane slice and answer 404.  The access log
goes through ``logging``.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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


class ScoringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the service for its handlers."""

    daemon_threads = True

    def __init__(self, address, service: ScoringService):
        super().__init__(address, ScoreHandler)
        self.service = service


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

    def do_GET(self) -> None:
        if self.path.partition("?")[0] != "/healthz":
            self._reply(404, {"status": "error", "reason": "unknown path"})
            return
        summary = self.server.service.health_summary()
        self._reply(503 if summary["draining"] else 200, summary)

    def do_POST(self) -> None:
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
            tenant = payload.get("tenant") or self.headers.get("X-MemVul-Tenant")
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


def run_http_server(service: ScoringService, host: str = "127.0.0.1", port: int = 0) -> ScoringHTTPServer:
    """Bind (port 0 = ephemeral; read ``server.server_address``) and serve
    on a daemon thread.  Stop with ``server.shutdown()``, then
    ``service.drain()``."""
    server = ScoringHTTPServer((host, port), service)
    threading.Thread(target=server.serve_forever, name="memvul-serve-http", daemon=True).start()
    logger.info("scoring service listening on http://%s:%d (POST /score, GET /healthz)",
                *server.server_address[:2])
    return server
