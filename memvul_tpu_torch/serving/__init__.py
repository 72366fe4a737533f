"""Online scoring: the micro-batching service, its dispatch strategies
(bucketed, ragged, continuous), the clients and the HTTP front end."""

from .client import HTTPClient, InprocessClient
from .service import ScoreFuture, ScoringService, ServiceConfig

__all__ = ["HTTPClient", "InprocessClient", "ScoreFuture", "ScoringService", "ServiceConfig"]
