"""Named tenants: one warmed encoder, one anchor bank per organization
(the JAX package's ``serving/tenancy.py``).

The model embeds report text and knows no tenant; what differs per
organization is the anchor bank, which weakness memories a report is
matched against and how they are weighted.  So tenancy lives in the bank
plane: admission resolves a tenant id (the request's JSON ``tenant``
field, else the ``X-MemVul-Tenant`` header; absent means the default
tenant) to that tenant's bank snapshot, installed from the tenant's own
:class:`~memvul_tpu_torch.bankops.store.BankStore`.  The dispatchers group
each pull by tenant and take ONE bank snapshot per tenant group, so one
response never mixes two banks, per tenant.

:class:`TenantManager` only selects: it parses the spec, holds each
tenant's ``BankStore`` and records which store version is live.  The
control-plane work (encode, warm, install, per tenant and per replica) is
in the module's functions :func:`configure_tenants`,
:func:`install_tenant_bank`, :func:`promote_tenant` and
:func:`demote_tenant`; on a fleet an install rolls through
``router.rolling_swap``, scoped to one tenant's bank.

The ``bank.resolve`` fault point arms the resolution itself: a firing
errors that one request (counted in ``serve.errors``) and touches no other
tenant.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry import get_registry

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_TENANT",
    "TenantManager",
    "TenantSpecError",
    "configure_tenants",
    "install_tenant_bank",
    "parse_tenant_spec",
    "promote_tenant",
    "demote_tenant",
    "validate_tenant_name",
]

DEFAULT_TENANT = "default"

# tenant names become telemetry label segments (serve.<tenant>.*,
# bank.<tenant>.*) and store subdir names, so the charset is strict
_TENANT_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,63}$")


class TenantSpecError(ValueError):
    """A malformed ``--tenants`` spec or unknown tenant id."""


def validate_tenant_name(name: str) -> str:
    """Validate a single tenant name against the telemetry-label
    charset (the ``bank --tenant`` CLI path).  Returns the name."""
    name = str(name)
    if not _TENANT_NAME_RE.match(name):
        raise TenantSpecError(
            f"tenant name {name!r} must match [a-z0-9][a-z0-9_-]* "
            "(it becomes a telemetry label segment)"
        )
    return name


def parse_tenant_spec(spec: str) -> Dict[str, str]:
    """``"orgA=/path/a,orgB=/path/b"`` → ``{name: store_dir}``.

    Names are validated against the telemetry-label charset and must
    be unique; ``default`` is reserved for the archive's own golden
    bank (the back-compat tenant every untagged request maps to)."""
    out: Dict[str, str] = {}
    for clause in str(spec).split(","):
        clause = clause.strip()
        if not clause:
            continue
        name, sep, path = clause.partition("=")
        name, path = name.strip(), path.strip()
        if not sep or not path:
            raise TenantSpecError(
                f"tenant clause {clause!r} is not name=store_dir"
            )
        if not _TENANT_NAME_RE.match(name):
            raise TenantSpecError(
                f"tenant name {name!r} must match [a-z0-9][a-z0-9_-]* "
                "(it becomes a telemetry label segment)"
            )
        if name == DEFAULT_TENANT:
            raise TenantSpecError(
                f"{DEFAULT_TENANT!r} is reserved for the archive's own "
                "bank — untagged requests map to it"
            )
        if name in out:
            raise TenantSpecError(f"tenant {name!r} appears twice")
        out[name] = path
    if not out:
        raise TenantSpecError(f"tenant spec {spec!r} names no tenants")
    return out


class TenantManager:
    """Selection-only tenant registry: name → ``BankStore`` plus the live
    store-version bookkeeping.  Every method is a dict probe under a lock;
    installs go through the module's functions."""

    def __init__(self, stores: Dict[str, Any], registry=None) -> None:
        self._stores = dict(stores)
        self._lock = threading.Lock()
        self._live: Dict[str, Optional[str]] = {}
        self._tel = registry if registry is not None else get_registry()

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self._stores))

    def store(self, tenant: str):
        try:
            return self._stores[tenant]
        except KeyError:
            raise TenantSpecError(f"unknown tenant {tenant!r}") from None

    def record_live(self, tenant: str, store_version: Optional[str]) -> None:
        """Note which store version is serving for ``tenant`` (set by
        the install helpers after the swap lands)."""
        self.store(tenant)  # validate the name before recording
        with self._lock:
            self._live[tenant] = store_version

    def live_version(self, tenant: str) -> Optional[str]:
        with self._lock:
            return self._live.get(tenant)

    def summary(self) -> Dict[str, Any]:
        """The /healthz-attachable view: per-tenant live store version."""
        with self._lock:
            live = dict(self._live)
        return {
            "tenants": [
                {"tenant": name, "store_version": live.get(name)}
                for name in self.tenants
            ],
        }


def _active_instances(store) -> Tuple[List[Dict[str, Any]], str]:
    """A store's serving candidate: the ACTIVE pointer, else latest."""
    pointer = store.active()
    version = pointer["version"] if pointer else store.latest()
    if version is None:
        raise TenantSpecError(
            f"bank store {store.root} is empty — run `bank build` first"
        )
    return list(store.instances(version)), version


def install_tenant_bank(
    target,
    tenant: str,
    instances: List[Dict[str, Any]],
    source: str = "tenancy",
    store_version: Optional[str] = None,
) -> int:
    """Encode, warm and install one tenant's bank on a single service, or
    roll it across a fleet one drained replica at a time (the shape of
    ``bankops.promote._install``, scoped to one tenant)."""
    if hasattr(target, "replicas"):
        from .router import rolling_swap

        return rolling_swap(
            target, instances,
            source=source, store_version=store_version, tenant=tenant,
        )
    return target.swap_bank(
        instances, source=source, store_version=store_version, tenant=tenant
    )


def configure_tenants(target, spec: str, registry=None) -> TenantManager:
    """Build the tenancy plane at serve startup: parse the spec, open
    each tenant's :class:`~memvul_tpu_torch.bankops.store.BankStore`,
    install every tenant's active bank (encoded and warmed off the request
    path) and attach the manager to ``target`` as ``tenant_manager``
    (``/healthz`` reads it)."""
    from ..bankops.store import BankStore

    stores = {
        name: BankStore(path)
        for name, path in parse_tenant_spec(spec).items()
    }
    manager = TenantManager(stores, registry=registry)
    for tenant in manager.tenants:
        instances, store_version = _active_instances(manager.store(tenant))
        install_tenant_bank(
            target, tenant, instances,
            source="startup", store_version=store_version,
        )
        manager.record_live(tenant, store_version)
        logger.info(
            "tenant %s: installed bank %s (%d anchors)",
            tenant, store_version, len(instances),
        )
    target.tenant_manager = manager
    return manager


def promote_tenant(
    target, manager: TenantManager, tenant: str, decision, registry=None
) -> int:
    """Gated per-tenant promotion: the standard
    :func:`~memvul_tpu_torch.bankops.promote.promote` gate and audit trail,
    installing through the tenant-scoped fleet path.  Returns the new
    serving bank version for that tenant."""
    from ..bankops.promote import promote

    version = promote(
        target, manager.store(tenant), decision,
        registry=registry, tenant=tenant,
    )
    if decision.approved:
        manager.record_live(tenant, decision.candidate)
    return version


def demote_tenant(
    target, manager: TenantManager, tenant: str, registry=None
) -> Dict[str, Any]:
    """Per-tenant rollback to the active store version's parent."""
    from ..bankops.promote import demote

    out = demote(
        target, manager.store(tenant), registry=registry, tenant=tenant
    )
    manager.record_live(tenant, out["version"])
    return out
