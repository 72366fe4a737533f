"""Clients for the scoring service (the JAX package's
``serving/client.py``).

:class:`InprocessClient` submits and blocks on the future, with no
sockets; :class:`HTTPClient` is its stdlib ``urllib`` twin for the HTTP
front end.  Both return the same response dicts.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from .service import ScoringService


class InprocessClient:
    """Synchronous in-process client: one ``score`` call = submit + wait."""

    def __init__(self, service: ScoringService) -> None:
        self.service = service

    def score(
        self,
        text: str,
        deadline_ms: Optional[float] = None,
        timeout_s: Optional[float] = 60.0,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        return self.service.submit(text, deadline_ms=deadline_ms, tenant=tenant).result(
            timeout=timeout_s)


class HTTPClient:
    """Minimal client for the JSON front end.

    Non-2xx responses carry the service's JSON body too (shed, deadline
    and error ride HTTP 5xx), so ``score`` returns it instead of raising.
    A deadlined request's socket timeout is its deadline plus
    ``deadline_slack_s``; a timed-out socket returns a
    ``"client_timeout"`` error dict."""

    def __init__(self, base_url: str, timeout_s: float = 60.0, deadline_slack_s: float = 5.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.deadline_slack_s = deadline_slack_s

    def _request(self, req: urllib.request.Request, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        timeout = self.timeout_s if timeout_s is None else timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            return json.loads(e.read().decode("utf-8"))
        except (TimeoutError, socket.timeout) as e:
            return {"status": "error", "reason": f"client_timeout after {timeout:.3f}s: {e}"}
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None), (TimeoutError, socket.timeout)):
                return {"status": "error", "reason": f"client_timeout after {timeout:.3f}s: {e.reason}"}
            raise

    def score(self, text: str, deadline_ms: Optional[float] = None,
              tenant: Optional[str] = None) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"text": text}
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        if tenant is not None:
            payload["tenant"] = tenant
        req = urllib.request.Request(
            self.base_url + "/score",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        timeout = deadline_ms / 1000.0 + self.deadline_slack_s if deadline_ms and deadline_ms > 0 else None
        return self._request(req, timeout_s=timeout)

    def health(self) -> Dict[str, Any]:
        return self._request(urllib.request.Request(self.base_url + "/healthz", method="GET"))
