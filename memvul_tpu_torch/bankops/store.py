"""Versioned anchor-bank store: the bank as a managed artifact (the JAX
package's ``bankops/store.py``, the same on-disk layout and digests, so
either package reads a store the other wrote).

* **immutable versions** — each version is a write-once directory
  ``<root>/v<N>/`` holding the anchor set (``anchors.json``, the
  ``data/cwe.py`` format, so a bank built by ``build-data`` imports as it
  is) and a ``bank_manifest.json`` carrying the sha256 of the anchor
  bytes.  Reads verify the digest: a tampered or torn artifact raises
  :class:`BankIntegrityError`;
* **lineage** — every derived version records its parent and the
  :class:`BankDiff` ops (``add`` / ``retire`` / ``reweight`` / ``edit``)
  that produced it; :meth:`BankStore.derive` is the only way to a
  non-root version;
* **promotion state** — ``ACTIVE.json`` points at the version operators
  consider live, and ``promotions.jsonl`` is the append-only audit trail
  (``bankops/promote.py``).

Every write goes through ``resilience.io.atomic_write_text`` (or the
``JsonlSink`` for the trail).  A version directory is committed by its
manifest: a crash between the anchor write and the manifest write leaves a
manifest-less directory that readers ignore and the next commit skips.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from ..resilience.io import atomic_write_text
from ..telemetry.sinks import JsonlSink, read_jsonl

ANCHORS_NAME = "anchors.json"
MANIFEST_NAME = "bank_manifest.json"
ACTIVE_NAME = "ACTIVE.json"
PROMOTIONS_NAME = "promotions.jsonl"

DIFF_OPS = ("add", "retire", "reweight", "edit")

_VERSION_RE = re.compile(r"^v(\d+)$")


class BankStoreError(ValueError):
    """Invalid store operation (bad diff, unknown version, reuse)."""


class BankIntegrityError(RuntimeError):
    """An on-disk artifact does not match its manifest digest."""


def canonical_anchor_text(anchors: Dict[str, str]) -> str:
    """The byte-stable serialization the sha256 manifest covers.  Keys
    are sorted so two builds of the same anchor set hash identically
    regardless of dict insertion order."""
    return json.dumps(anchors, indent=2, sort_keys=True, ensure_ascii=False)


def anchor_sha256(anchors: Dict[str, str]) -> str:
    return hashlib.sha256(
        canonical_anchor_text(anchors).encode("utf-8")
    ).hexdigest()


@dataclasses.dataclass(frozen=True)
class DiffOp:
    """One lineage operation.  ``add``/``edit`` carry a description,
    ``reweight`` a weight; ``retire`` only names its category."""

    op: str
    category: str
    description: Optional[str] = None
    weight: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"op": self.op, "category": self.category}
        if self.description is not None:
            out["description"] = self.description
        if self.weight is not None:
            out["weight"] = self.weight
        return out


class BankDiff:
    """An ordered list of :class:`DiffOp` — the ONLY way to derive a new
    bank version (:meth:`BankStore.derive`).  ``apply`` is pure: it
    validates every op against the parent state and returns the new
    ``(anchors, weights)`` without touching disk."""

    def __init__(self, ops: Iterable[DiffOp]) -> None:
        self.ops: List[DiffOp] = list(ops)
        for op in self.ops:
            if op.op not in DIFF_OPS:
                raise BankStoreError(
                    f"unknown diff op {op.op!r} (want one of {DIFF_OPS})"
                )
            if not op.category:
                raise BankStoreError(f"diff op {op.op!r} needs a category")

    @classmethod
    def from_json(cls, data: Iterable[Dict[str, Any]]) -> "BankDiff":
        ops = []
        for item in data:
            if not isinstance(item, dict):
                raise BankStoreError(f"diff op must be an object, got {item!r}")
            unknown = set(item) - {"op", "category", "description", "weight"}
            if unknown:
                raise BankStoreError(
                    f"diff op has unknown key(s) {sorted(unknown)}: {item!r}"
                )
            ops.append(DiffOp(
                op=str(item.get("op", "")),
                category=str(item.get("category", "")),
                description=item.get("description"),
                weight=(
                    float(item["weight"]) if item.get("weight") is not None
                    else None
                ),
            ))
        return cls(ops)

    def to_json(self) -> List[Dict[str, Any]]:
        return [op.to_json() for op in self.ops]

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.op] = out.get(op.op, 0) + 1
        return out

    def apply(
        self, anchors: Dict[str, str], weights: Dict[str, float]
    ) -> Tuple[Dict[str, str], Dict[str, float]]:
        anchors = dict(anchors)
        weights = dict(weights)
        for op in self.ops:
            cat = op.category
            if op.op == "add":
                if cat in anchors:
                    raise BankStoreError(
                        f"add {cat!r}: already in the bank (use edit)"
                    )
                if not op.description:
                    raise BankStoreError(f"add {cat!r} needs a description")
                anchors[cat] = op.description
                if op.weight is not None:
                    weights[cat] = op.weight
            elif op.op == "retire":
                if cat not in anchors:
                    raise BankStoreError(f"retire {cat!r}: not in the bank")
                del anchors[cat]
                weights.pop(cat, None)
            elif op.op == "edit":
                if cat not in anchors:
                    raise BankStoreError(
                        f"edit {cat!r}: not in the bank (use add)"
                    )
                if not op.description:
                    raise BankStoreError(f"edit {cat!r} needs a description")
                anchors[cat] = op.description
            elif op.op == "reweight":
                if cat not in anchors:
                    raise BankStoreError(f"reweight {cat!r}: not in the bank")
                if op.weight is None:
                    raise BankStoreError(f"reweight {cat!r} needs a weight")
                weights[cat] = op.weight
        return anchors, weights


class BankStore:
    """The on-disk versioned bank store (layout in the module docstring;)."""

    def __init__(self, root: Union[str, Path]) -> None:
        self.root = Path(root)

    # -- version enumeration ---------------------------------------------------

    def versions(self) -> List[str]:
        """Committed version ids, oldest first.  A directory without a
        manifest is an uncommitted crash remnant and is ignored."""
        if not self.root.is_dir():
            return []
        found: List[Tuple[int, str]] = []
        for child in self.root.iterdir():
            m = _VERSION_RE.match(child.name)
            if m and (child / MANIFEST_NAME).exists():
                found.append((int(m.group(1)), child.name))
        return [name for _, name in sorted(found)]

    def latest(self) -> Optional[str]:
        versions = self.versions()
        return versions[-1] if versions else None

    def _next_id(self) -> str:
        highest = 0
        if self.root.is_dir():
            for child in self.root.iterdir():
                m = _VERSION_RE.match(child.name)
                if m:  # skip past uncommitted remnants too — never reuse
                    highest = max(highest, int(m.group(1)))
        return f"v{highest + 1}"

    def _vdir(self, version: str) -> Path:
        if not _VERSION_RE.match(version):
            raise BankStoreError(f"bad version id {version!r} (want v<N>)")
        return self.root / version

    # -- create / derive -------------------------------------------------------

    def create(
        self,
        anchors: Dict[str, str],
        source: str = "build",
        note: Optional[str] = None,
        weights: Optional[Dict[str, float]] = None,
    ) -> Dict[str, Any]:
        """Commit a ROOT version (no parent, empty diff) from a full
        anchor set — e.g. the ``build-data`` output imported wholesale.
        Returns the committed manifest."""
        if not anchors:
            raise BankStoreError("refusing to commit an empty anchor set")
        return self._commit(
            anchors, dict(weights or {}), parent=None, diff=[],
            source=source, note=note,
        )

    def derive(
        self,
        parent: str,
        diff: BankDiff,
        source: str = "diff",
        note: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Apply ``diff`` to ``parent`` and commit the result as a new
        version — the only path to a non-root version, so lineage is
        complete by construction."""
        if not diff.ops:
            raise BankStoreError("empty diff — nothing to derive")
        parent_manifest = self.manifest(parent)
        anchors = self.anchors(parent)
        weights = dict(parent_manifest.get("weights") or {})
        new_anchors, new_weights = diff.apply(anchors, weights)
        if not new_anchors:
            raise BankStoreError(
                f"diff retires every anchor of {parent} — refusing an "
                "empty bank"
            )
        return self._commit(
            new_anchors, new_weights, parent=parent, diff=diff.to_json(),
            source=source, note=note,
        )

    def _commit(
        self,
        anchors: Dict[str, str],
        weights: Dict[str, float],
        parent: Optional[str],
        diff: List[Dict[str, Any]],
        source: str,
        note: Optional[str],
    ) -> Dict[str, Any]:
        version = self._next_id()
        vdir = self._vdir(version)
        vdir.mkdir(parents=True, exist_ok=False)  # versions are write-once
        text = canonical_anchor_text(anchors)
        atomic_write_text(vdir / ANCHORS_NAME, text)
        manifest = {
            "version": version,
            "parent": parent,
            "source": source,
            "note": note,
            "n_anchors": len(anchors),
            "anchors_sha256": hashlib.sha256(
                text.encode("utf-8")
            ).hexdigest(),
            "weights": weights,
            "diff": diff,
            "created_wall": time.time(),
        }
        # the manifest write IS the commit: readers treat a manifest-less
        # version dir as garbage, so a crash here leaves no torn version
        atomic_write_text(
            vdir / MANIFEST_NAME, json.dumps(manifest, indent=2)
        )
        return manifest

    # -- reads -----------------------------------------------------------------

    def manifest(self, version: str) -> Dict[str, Any]:
        path = self._vdir(version) / MANIFEST_NAME
        try:
            return json.loads(path.read_text(encoding="utf-8"))
        except OSError:
            raise BankStoreError(
                f"unknown bank version {version!r} in {self.root}"
            ) from None

    def anchors(self, version: str, verify: bool = True) -> Dict[str, str]:
        """The version's anchor set, digest-verified against its
        manifest by default."""
        manifest = self.manifest(version)
        text = (self._vdir(version) / ANCHORS_NAME).read_text(
            encoding="utf-8"
        )
        if verify:
            digest = hashlib.sha256(text.encode("utf-8")).hexdigest()
            if digest != manifest.get("anchors_sha256"):
                raise BankIntegrityError(
                    f"bank {version}: anchors.json sha256 {digest[:12]}… "
                    f"does not match manifest "
                    f"{str(manifest.get('anchors_sha256'))[:12]}…"
                )
        return json.loads(text)

    def verify(self, version: str) -> bool:
        """Digest-check one version; raises :class:`BankIntegrityError`
        on mismatch, returns True when intact."""
        self.anchors(version, verify=True)
        return True

    def instances(self, version: str) -> List[Dict[str, Any]]:
        """The version as anchor *instances* — the exact shape
        ``MemoryReader.read_anchors`` yields, so a store version feeds
        ``SiamesePredictor.encode_anchors`` / ``swap_bank`` directly.
        Per-anchor weights ride in ``meta["weight"]``: the probabilities
        are unweighted, a service picks its winner by the weighted
        ``argmax``."""
        manifest = self.manifest(version)
        weights = dict(manifest.get("weights") or {})
        return [
            {
                "text1": description,
                "label": "same",
                "meta": {
                    "type": "golden",
                    "label": category,
                    "weight": float(weights.get(category, 1.0)),
                    "bank_version": version,
                },
            }
            for category, description in self.anchors(version).items()
        ]

    def log(self, version: Optional[str] = None) -> List[Dict[str, Any]]:
        """Lineage of ``version`` (default: latest), root first — each
        entry is the committed manifest."""
        version = version or self.latest()
        if version is None:
            return []
        chain: List[Dict[str, Any]] = []
        seen = set()
        current: Optional[str] = version
        while current is not None:
            if current in seen:  # defensive: a hand-edited cycle
                raise BankStoreError(f"lineage cycle at {current!r}")
            seen.add(current)
            manifest = self.manifest(current)
            chain.append(manifest)
            current = manifest.get("parent")
        chain.reverse()
        return chain

    # -- promotion state -------------------------------------------------------

    def set_active(
        self, version: str, source: str = "manual"
    ) -> Dict[str, Any]:
        """Point ``ACTIVE.json`` at a committed version (atomic — an
        operator never reads a torn pointer)."""
        self.manifest(version)  # must exist and be committed
        record = {
            "version": version,
            "source": source,
            "promoted_wall": time.time(),
        }
        atomic_write_text(
            self.root / ACTIVE_NAME, json.dumps(record, indent=2)
        )
        return record

    def active(self) -> Optional[Dict[str, Any]]:
        try:
            obj = json.loads(
                (self.root / ACTIVE_NAME).read_text(encoding="utf-8")
            )
        except (OSError, ValueError):
            return None
        return obj if isinstance(obj, dict) else None

    def record_promotion(self, **fields: Any) -> None:
        """Append one audit record to ``promotions.jsonl`` (gate
        decisions, promotions, demotions — bankops/promote.py)."""
        fields.setdefault("t", round(time.time(), 3))
        sink = JsonlSink(self.root / PROMOTIONS_NAME)
        try:
            sink.emit(fields)
        finally:
            sink.close()

    def promotions(self) -> List[Dict[str, Any]]:
        records, _ = read_jsonl(self.root / PROMOTIONS_NAME)
        return records
