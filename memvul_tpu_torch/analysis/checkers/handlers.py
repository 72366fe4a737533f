"""MV102 — handler threads only enqueue + wait; routers only select;
dispatcher admission paths never block (the JAX package's checker, with
the same class families and rules; the blocking set adds eager
PyTorch's device→host syncs).

The class families, wherever they live:

* classes with a base whose name ends with ``RequestHandler`` — one
  thread per connection; anything blocking serializes the whole server
  behind one client and puts device work on a connection thread, which
  the micro-batcher exists to prevent;
* classes named ``*Router`` (or deriving from one) — a routing decision
  reads queue depths and picks a replica, nothing more; heavy fleet
  operations belong to control-plane workers;
* classes named ``*Balancer`` or ``*Autoscaler`` (or deriving from
  one; serving/fleet.py, serving/autoscaler.py) — the same selection-
  only discipline one level up: a host-routing or scale decision reads
  cached health/queue/hint state and picks; kills, restart backoff,
  spawn warmups, and drain waits belong to the module-level recovery/
  scale workers on their own threads;
* classes named ``*Recorder`` (or deriving from one;
  serving/incident.py) — the incident flight recorder's trigger side
  runs on whatever thread noticed the problem (router sweep, fleet
  monitor, alert engine), so the same no-scoring/no-sleeping contract
  applies: a trigger is a bounded-queue put and a dump reads
  snapshots; a recorder that scored or slept inline would couple the
  post-mortem plane to the request path it exists to observe;
* classes named ``*Cache`` (or deriving from one;
  serving/admission_cache.py) — the admission cache sits ON the
  request hot path (every submit probes it), so a lookup/store must be
  a dict probe under a short lock and nothing else: a cache that
  encoded, scored, or slept inline would cost every request what it
  exists to save the occasional duplicate;
* classes named ``*Tenant*`` (name or base contains ``Tenant``;
  serving/tenancy.py) — tenant managers resolve names to stores and
  record liveness; installing banks, encoding, and fleet rollouts are
  the module-level ``configure_tenants``/``promote_tenant`` helpers'
  job, so a manager method that swapped or scored inline would smuggle
  control-plane work onto whatever thread asked for a lookup;
* classes named ``*Dispatcher`` (or deriving from one;
  serving/dispatch.py) — the batcher strategies themselves.  Their JOB
  is to encode, pack, and score, so the serving-surface names stay
  legal here; what the admission path must never do is stall on a
  synchronous convenience API (``score_texts`` round-trips the device
  per call) or a bare ``time.sleep`` (waits go through condition
  variables and queue timeouts so drain/kill flags are noticed), and
  ``predict*`` entry points are offline-evaluation surface, not
  dispatch surface.  Continuous admission makes this structural: a
  blocked admission loop re-couples queue_wait to device latency — the
  exact coupling the dispatcher exists to remove.

The forbidden-name set is the serving tier's scoring/encoding/packing
surface plus ``sleep``, the fleet control-plane entry points
(``swap_bank``/``install_bank``/``rolling_swap``) and the device→host
syncs (``torch.cuda.synchronize`` and an event's or stream's
``.synchronize()``, ``.item()``, ``.cpu()``, ``.tolist()``, and the JAX
names ``block_until_ready``/``device_get``); ``predict*`` is banned by
prefix.  A dispatcher may not ``synchronize`` the device on its
admission path either.  The observability endpoints (``/metrics``,
``/tracez``, ``/profilez``; serving/frontend.py) live under the same
rule: they may only read *snapshots* — registry snapshots, the trace
ring, a monitor's ``status()`` — so a scrape can never stall the
batcher.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import AnalysisContext, Finding, called_name, register

CODE = "MV102"

FORBIDDEN_NAMES = {
    "sleep",
    "score_instances",
    "score_texts",
    "encode_anchors",
    "encode_bank",
    "warmup_compile",
    "warmup_bank_shapes",
    "swap_bank",
    "install_bank",
    "_score_fn",
    "_ragged_score_fn",
    # the ragged serve path's packing/collation (docs/ragged_serving.md):
    # packing is batcher-thread work; a handler or router that packs
    # inline serializes the process exactly like inline scoring would
    "pack_token_budget",
    "collate_ragged",
    # fleet rollouts are control-plane work (drain + encode + warm per
    # replica); an endpoint that triggers one inline would wedge every
    # connection behind the rollout
    "rolling_swap",
    # device→host syncs: the connection or routing thread would wait for
    # the card to drain (eager PyTorch's, and the JAX names)
    "synchronize",
    "item",
    "cpu",
    "tolist",
    "block_until_ready",
    "device_get",
}
FORBIDDEN_PREFIXES = ("predict",)

# the dispatcher admission-path set is deliberately NARROW: packing,
# collation, encoding and the jitted score fns are a dispatcher's whole
# purpose — only the stall-shaped calls are banned (see module docstring)
DISPATCHER_FORBIDDEN_NAMES = {"sleep", "score_texts", "synchronize"}


def _base_name(base: ast.expr) -> str:
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _is_handler_class(node: ast.ClassDef) -> bool:
    return any(
        _base_name(b).endswith("RequestHandler") for b in node.bases
    )


def _is_router_class(node: ast.ClassDef) -> bool:
    if node.name.endswith("Router"):
        return True
    return any(_base_name(b).endswith("Router") for b in node.bases)


def _is_balancer_class(node: ast.ClassDef) -> bool:
    # host balancers and autoscalers make routing/control decisions
    # under the same selection-only contract as routers
    for suffix in ("Balancer", "Autoscaler"):
        if node.name.endswith(suffix):
            return True
        if any(_base_name(b).endswith(suffix) for b in node.bases):
            return True
    return False


def _is_recorder_class(node: ast.ClassDef) -> bool:
    # the incident flight recorder (serving/incident.py): its trigger
    # side runs on router/fleet/alert threads, so it inherits the full
    # selection-only forbidden set
    if node.name.endswith("Recorder"):
        return True
    return any(_base_name(b).endswith("Recorder") for b in node.bases)


def _is_cache_class(node: ast.ClassDef) -> bool:
    # the admission cache (serving/admission_cache.py) is probed on
    # every submit: lookup/store are dict ops under a short lock, never
    # encoding/scoring/sleeping
    if node.name.endswith("Cache"):
        return True
    return any(_base_name(b).endswith("Cache") for b in node.bases)


def _is_tenant_class(node: ast.ClassDef) -> bool:
    # tenant managers (serving/tenancy.py) resolve names to stores —
    # selection only; installs/rollouts live in module-level helpers
    if "Tenant" in node.name:
        return True
    return any("Tenant" in _base_name(b) for b in node.bases)


def _is_dispatcher_class(node: ast.ClassDef) -> bool:
    if node.name.endswith("Dispatcher"):
        return True
    return any(_base_name(b).endswith("Dispatcher") for b in node.bases)


@register(
    CODE,
    "blocking-in-handler",
    "blocking call in an HTTP handler, router, or dispatcher class",
)
def check(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if (
                _is_handler_class(node)
                or _is_router_class(node)
                or _is_balancer_class(node)
                or _is_recorder_class(node)
                or _is_cache_class(node)
                or _is_tenant_class(node)
            ):
                forbidden = FORBIDDEN_NAMES
                contract = (
                    "a handler may only submit() and wait on the future; "
                    "a router/balancer/autoscaler may only select from "
                    "cached state; a recorder may only enqueue triggers "
                    "and dump snapshots; a cache may only probe its map; "
                    "a tenant manager may only resolve names"
                )
            elif _is_dispatcher_class(node):
                forbidden = DISPATCHER_FORBIDDEN_NAMES
                contract = (
                    "a dispatcher's admission path waits on condition "
                    "variables and queue timeouts, never sleeps or "
                    "round-trips the device per request"
                )
            else:
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                name = called_name(call)
                if name in forbidden or name.startswith(FORBIDDEN_PREFIXES):
                    yield Finding(
                        CODE, pf.rel, call.lineno,
                        f"blocking call {name}() inside {node.name} — "
                        f"{contract}",
                        symbol=name,
                    )
