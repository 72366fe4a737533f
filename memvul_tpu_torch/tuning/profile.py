"""Tuned-profile store: versioned, sha256-manifested, per device class.

Layout (``<root>/<device_class>/``)::

    profile-0001.json     # immutable profile documents, one per tune run
    profile-0002.json
    MANIFEST.json         # {"schema", "device_class", "version",
                          #  "active": "profile-0002.json",
                          #  "sha256": <of the active document>}

Writes follow the BankStore/checkpoint idiom — every file lands through
``atomic_write_text`` and the manifest commit is the atomic pointer
advance, so a kill mid-write leaves the previous profile intact.  Loads
verify the manifest checksum and the document schema; ANY failure
(missing file, torn JSON, checksum mismatch, stale schema) degrades to
"no profile" with one warning per path — the build entry points then
run on today's shipped defaults, exactly as if no tuner had ever run.

The device class is the normalized card name
(``telemetry.programs.device_info``: ``nvidia_h100_80gb_hbm3`` on the
H100, whose ``PEAK_SPECS`` row the ``h100`` marker finds; ``cpu`` on the
CPU).  A class with no peak-spec row still *loads* a profile fine (the
profile was measured, not derived from a roofline) — the refusal to TUNE
against a made-up roofline lives in :mod:`.autotune`.  The document and
manifest formats are the JAX package's, so either package reads a store
the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Set, Tuple, Union

logger = logging.getLogger(__name__)

PROFILE_SCHEMA = 1
MANIFEST_NAME = "MANIFEST.json"

# env override for the profile root; the tuning.profile_dir config key
# wins over it, explicit config always wins over any loaded profile
PROFILE_DIR_ENV = "MEMVUL_TUNED_PROFILES"

# knobs a profile may carry per section; anything else is dropped at
# apply time (a stale profile from a newer schema cannot smuggle an
# unknown key into a TrainerConfig/ServiceConfig constructor)
TRAIN_PROFILE_KEYS = ("train_buckets", "dedup_anchors", "prefetch_depth")
SERVING_PROFILE_KEYS = (
    "score_impl", "max_batch", "max_wait_ms", "token_budget",
    "max_rows_per_pack", "cascade_low", "cascade_high",
)

# one warning per offending path per process — a serving fleet that
# builds N replicas through the same corrupt profile logs once, not N
# times
_warned_paths: Set[str] = set()


def _warn_once(path: Path, message: str) -> None:
    key = str(path)
    if key in _warned_paths:
        return
    _warned_paths.add(key)
    logger.warning("tuned profile %s: %s — falling back to defaults",
                   path, message)


def normalize_device_class(kind: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` → ``"nvidia_h100_80gb_hbm3"`` — filesystem- and
    metric-suffix-safe."""
    return re.sub(r"[^a-z0-9]+", "_", str(kind).lower()).strip("_") or "unknown"


def resolve_device_class(
    override: Optional[str] = None,
    device: Any = None,
) -> Tuple[str, Optional[Dict[str, float]]]:
    """(device_class, peak_spec_or_None) for the current CUDA card (the
    CPU without one), or for an explicit override (cross-class tuning /
    tests)."""
    from ..telemetry.programs import device_info, peak_spec

    if override:
        return normalize_device_class(override), peak_spec(str(override))
    _platform, kind = device_info(device)
    return normalize_device_class(kind), peak_spec(kind)


def profile_root(configured: Optional[Union[str, Path]] = None) -> Optional[Path]:
    """The tuned-profile root directory: the ``tuning.profile_dir``
    config value when set, else ``$MEMVUL_TUNED_PROFILES``, else None
    (no profile loading at all — the zero-config default)."""
    if configured:
        return Path(configured)
    env = os.environ.get(PROFILE_DIR_ENV)
    return Path(env) if env else None


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def save_profile(
    root: Union[str, Path],
    device_class: str,
    profile: Dict[str, Any],
) -> Path:
    """Persist one tune run's output as the next profile version and
    advance the manifest pointer.  Returns the written document path."""
    from ..resilience.io import atomic_write_text

    class_dir = Path(root) / normalize_device_class(device_class)
    class_dir.mkdir(parents=True, exist_ok=True)
    manifest_path = class_dir / MANIFEST_NAME
    version = 0
    if manifest_path.exists():
        try:
            version = int(json.loads(manifest_path.read_text()).get("version", 0))
        except (ValueError, json.JSONDecodeError):
            # a torn manifest must not wedge the writer; restart at the
            # highest on-disk document version
            versions = [
                int(m.group(1))
                for p in class_dir.glob("profile-*.json")
                if (m := re.match(r"profile-(\d+)\.json$", p.name))
            ]
            version = max(versions, default=0)
    version += 1
    document = dict(profile)
    document["schema"] = PROFILE_SCHEMA
    document["device_class"] = normalize_device_class(device_class)
    document["version"] = version
    document.setdefault("created_wall", time.time())
    text = json.dumps(document, indent=2, sort_keys=True, default=float)
    doc_name = f"profile-{version:04d}.json"
    atomic_write_text(class_dir / doc_name, text)
    atomic_write_text(manifest_path, json.dumps({
        "schema": PROFILE_SCHEMA,
        "device_class": document["device_class"],
        "version": version,
        "active": doc_name,
        "sha256": _sha256(text),
    }, indent=2))
    return class_dir / doc_name


def load_profile(
    root: Optional[Union[str, Path]],
    device_class: str,
) -> Optional[Dict[str, Any]]:
    """The active tuned profile for a device class, checksum-verified,
    or None (no root configured / no profile for this class / any
    corruption — each failure warns once and degrades to defaults)."""
    if root is None:
        return None
    class_dir = Path(root) / normalize_device_class(device_class)
    manifest_path = class_dir / MANIFEST_NAME
    if not manifest_path.exists():
        return None  # untuned device class: silent defaults, not a warning
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        _warn_once(manifest_path, f"unreadable manifest ({e})")
        return None
    doc_path = class_dir / str(manifest.get("active") or "")
    if not doc_path.is_file():
        _warn_once(manifest_path,
                   f"active document {manifest.get('active')!r} missing")
        return None
    try:
        text = doc_path.read_text()
    except OSError as e:
        _warn_once(doc_path, f"unreadable ({e})")
        return None
    if _sha256(text) != manifest.get("sha256"):
        _warn_once(doc_path, "sha256 mismatch vs MANIFEST.json")
        return None
    try:
        document = json.loads(text)
    except json.JSONDecodeError as e:
        _warn_once(doc_path, f"torn JSON ({e})")
        return None
    if document.get("schema") != PROFILE_SCHEMA:
        _warn_once(
            doc_path,
            f"stale schema {document.get('schema')!r} "
            f"(this build reads {PROFILE_SCHEMA})",
        )
        return None
    return document


def _emit_device_class_gauge(device_class: str, applied: bool) -> None:
    """``tune.device_class.<class>`` — 1.0 when a tuned profile was
    applied for this class, 0.0 when the build fell back to defaults
    (untuned class, disabled loading, or a corrupt store)."""
    from ..telemetry import get_registry

    get_registry().gauge(f"tune.device_class.{device_class}").set(
        1.0 if applied else 0.0
    )


def _load_for_build(config) -> Tuple[Optional[Dict[str, Any]], str]:
    """Shared by the two apply helpers: resolve (profile_or_None,
    device_class) from a run config's ``tuning`` section."""
    from ..config import tuning_config

    tcfg = tuning_config(config)
    device_class, _peak = resolve_device_class(tcfg.get("device_class"))
    if not bool(tcfg["enabled"]):
        return None, device_class
    root = profile_root(tcfg.get("profile_dir"))
    return load_profile(root, device_class), device_class


def apply_tuned_trainer(
    trainer_cfg: Dict[str, Any], config: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    """Overlay the tuned profile's training knobs UNDER the config's
    explicit ``trainer`` section: a knob the user wrote wins untouched;
    only absent knobs take the tuned value.  No profile → the dict
    comes back unchanged (byte-identical pre-tuner behavior)."""
    profile, device_class = _load_for_build(config)
    tuned = dict((profile or {}).get("train") or {})
    applied = {}
    for key in TRAIN_PROFILE_KEYS:
        if key in tuned and key not in trainer_cfg:
            trainer_cfg[key] = tuned[key]
            applied[key] = tuned[key]
    _emit_device_class_gauge(device_class, bool(applied))
    if applied:
        logger.info(
            "tuned profile %s v%s: applied trainer knobs %s",
            device_class, (profile or {}).get("version"), applied,
        )
    return trainer_cfg


def apply_tuned_serving(
    serve_cfg: Dict[str, Any],
    explicit_section: Optional[Dict[str, Any]],
    config: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """Overlay the tuned profile's serving knobs under the archive
    config's explicit ``serving`` section.  ``serve_cfg`` is the
    defaults-merged view (``config.serving_config``), so explicitness is
    judged against the RAW section: a key the archive/overrides wrote
    (non-null) always wins; knobs the profile tuned fill the rest."""
    profile, device_class = _load_for_build(config)
    tuned = dict((profile or {}).get("serving") or {})
    explicit = {
        k for k, v in (explicit_section or {}).items() if v is not None
    }
    applied = {}
    for key in SERVING_PROFILE_KEYS:
        if key in tuned and key not in explicit:
            serve_cfg[key] = tuned[key]
            applied[key] = tuned[key]
    _emit_device_class_gauge(device_class, bool(applied))
    if applied:
        logger.info(
            "tuned profile %s v%s: applied serving knobs %s",
            device_class, (profile or {}).get("version"), applied,
        )
    return serve_cfg
