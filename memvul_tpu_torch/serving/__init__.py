"""Online scoring: the micro-batching service, its dispatch strategies
(bucketed, ragged, continuous, cascade), the clients and the HTTP front
end; and the fleet on one host: replicas behind a health-gated router
with rolling bank swaps, named tenants, the admission cache, the SLO
monitor and the load generator.

The ops plane: the cross-host balancer (:class:`HostBalancer` over
:class:`LocalHost` and :class:`ProcessHost` hosts), the
:class:`Autoscaler` and the incident flight recorder
(:func:`attach_flight_recorder`).

``build.serve_from_archive`` builds a :class:`ScoringService`, or with
``serving.replicas > 1`` (or ``serving.autoscale_enabled``) a
:class:`ReplicaRouter`; ``python -m memvul_tpu_torch serve [--replicas N]
[--tenants SPEC] [--tsdb-cadence S]`` puts the front end over either, and
``serve --hosts`` over a balancer of running serve processes.
"""

from .service import (  # noqa: F401
    MANIFEST_NAME,
    STATUS_DEADLINE,
    STATUS_DRAIN,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
    ScoreFuture,
    ScoringService,
    ServiceConfig,
)
from .client import HTTPClient, InprocessClient  # noqa: F401
from .replica import (  # noqa: F401
    REPLICA_DEAD,
    REPLICA_HEALTHY,
    REPLICA_RETIRED,
    REPLICA_SWAPPING,
    REPLICA_UNHEALTHY,
    Replica,
    ReplicaDead,
)
from .router import ReplicaRouter, RouterConfig, rolling_swap  # noqa: F401
from .admission_cache import AdmissionCache, text_digest  # noqa: F401
from .tenancy import (  # noqa: F401
    DEFAULT_TENANT,
    TenantManager,
    TenantSpecError,
    configure_tenants,
    demote_tenant,
    install_tenant_bank,
    parse_tenant_spec,
    promote_tenant,
    validate_tenant_name,
)
from .loadgen import (  # noqa: F401
    LoadConfig,
    LoadGenerator,
    arrival_offsets,
    fleet_snapshot,
    request_deadlines,
    request_texts,
    run_slo_harness,
)
from .slo import (  # noqa: F401
    SCALE_DOWN,
    SCALE_HOLD,
    SCALE_UP,
    SLOConfig,
    SLOMonitor,
)
from .autoscaler import Autoscaler, AutoscalerConfig  # noqa: F401
from .fleet import (  # noqa: F401
    FleetConfig,
    HostBalancer,
    HostDead,
    LocalHost,
    ProcessHost,
    enumerate_hosts,
    start_process_hosts,
)
from .incident import IncidentRecorder, attach_flight_recorder  # noqa: F401
