"""Checkpoint and resume with ``torch.save`` (the JAX package's
``training/checkpoint.py``, there with orbax).

Two families share one directory: per-**epoch** state under
``epochs/<n>/`` and mid-epoch per-**step** state (preemption saves,
``save_every_steps``) under ``steps/<n>/``, each keeping its newest
``max_to_keep`` (steps at least 2).  A checkpoint is committed by renaming
its finished staging directory into place, so a crash mid-write leaves
the previous one intact, and each committed checkpoint gets a checksum
manifest (``manifest_<family>_<n>.json``, sha256 per file) that restore
verifies: a corrupt newest checkpoint falls back to the previous good
one.  The best checkpoint swaps through ``best_tmp``/``best_old`` so a
crash at any point leaves a committed best (:meth:`_recover_best`).
Saves are synchronous.  The anchor bank is derived state and is not
saved: it is re-encoded from the anchor texts.

These checkpoints are the port's own; archives (``model.tar.gz``) are
what the JAX package reads.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..resilience.io import atomic_write_text

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def write_state(directory: Path, state: Dict[str, Any]) -> None:
    """Save ``state`` as ``directory/state.pt``, committed by renaming a
    finished staging directory (``<name>.partial-<pid>``) into place."""
    directory = Path(directory)
    staging = directory.with_name(f"{directory.name}.partial-{os.getpid()}")
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    torch.save(state, staging / STATE_FILE)
    if directory.exists():
        shutil.rmtree(directory)
    staging.rename(directory)


def read_state(directory: Path) -> Dict[str, Any]:
    return torch.load(Path(directory) / STATE_FILE, map_location="cpu", weights_only=False)


class TrainCheckpointer:
    """Tracks 'latest' and 'best' training state under one directory."""

    def __init__(self, directory: Union[str, Path], max_to_keep: int = 2) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._keep = {"epochs": max(1, int(max_to_keep)), "steps": max(2, int(max_to_keep))}
        self._best_dir = self.directory / "best"

    # -- families --------------------------------------------------------------

    def _checkpoint_dir(self, family: str, step: int) -> Path:
        return self.directory / family / str(step)

    def all_steps(self, family: str) -> List[int]:
        root = self.directory / family
        if not root.exists():
            return []
        return sorted(int(p.name) for p in root.iterdir() if p.is_dir() and p.name.isdigit())

    def _commit(self, family: str, step: int, state: Dict[str, Any]) -> None:
        write_state(self._checkpoint_dir(family, step), state)
        self._write_manifest(family, step)
        for old in self.all_steps(family)[: -self._keep[family]]:
            shutil.rmtree(self._checkpoint_dir(family, old))
        self._prune_stale_manifests()

    # -- per-epoch state -----------------------------------------------------

    def save(
        self,
        step: int,
        state: Dict[str, Any],
        is_best: bool = False,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Commit epoch ``step``'s state (host tensors), its metrics sidecar
        and, when ``is_best``, the best copy."""
        self._commit("epochs", step, state)
        if metadata is not None:
            atomic_write_text(
                self.directory / f"metrics_epoch_{step}.json",
                json.dumps(metadata, indent=2, default=float),
            )
        if is_best:
            # write the replacement beside the old best, move the old one
            # aside, rename the new one into place, delete the old copy: a
            # crash at any point leaves a committed best under ``best``,
            # ``best_tmp`` or ``best_old``
            tmp = self.directory / "best_tmp"
            old = self.directory / "best_old"
            self._recover_best()
            # glob, not exact names: a crash mid-write leaves staging
            # litter (best_tmp.partial-*) beside them
            for stale in (*self.directory.glob("best_tmp*"), *self.directory.glob("best_old*")):
                if stale.exists():
                    shutil.rmtree(stale)
            write_state(tmp, state)
            if self._best_dir.exists():
                self._best_dir.rename(old)
            tmp.rename(self._best_dir)
            if old.exists():
                shutil.rmtree(old)

    def _recover_best(self) -> None:
        """Finish an interrupted best-swap, newest copy first.  A
        ``best_tmp`` is always committed and newer than any ``best`` beside
        it (the swap writes it before touching ``best``), so it wins even
        when ``best`` exists; ``best_old`` is the pre-swap copy, promoted
        only when ``best`` is missing."""
        tmp = self.directory / "best_tmp"
        old = self.directory / "best_old"
        if tmp.exists():
            if self._best_dir.exists():
                shutil.rmtree(self._best_dir)
            tmp.rename(self._best_dir)
        elif not self._best_dir.exists() and old.exists():
            old.rename(self._best_dir)

    # -- checksum manifests --------------------------------------------------

    def _manifest_path(self, family: str, step: int) -> Path:
        return self.directory / f"manifest_{family}_{step}.json"

    def _write_manifest(self, family: str, step: int) -> None:
        root = self._checkpoint_dir(family, step)
        files = {}
        for p in sorted(root.rglob("*")):
            if p.is_file():
                files[str(p.relative_to(root))] = hashlib.sha256(p.read_bytes()).hexdigest()
        atomic_write_text(
            self._manifest_path(family, step),
            json.dumps({"family": family, "step": step, "files": files}, indent=2),
        )

    def verify_manifest(self, family: str, step: int) -> bool:
        """True when every file the manifest records hashes clean.  A
        missing manifest passes; an unreadable one fails."""
        mpath = self._manifest_path(family, step)
        if not mpath.exists():
            return True
        try:
            manifest = json.loads(mpath.read_text())
        except ValueError:
            logger.warning("manifest %s is unreadable: treating %s/%d as corrupt", mpath, family, step)
            return False
        root = self._checkpoint_dir(family, step)
        for rel, digest in manifest.get("files", {}).items():
            p = root / rel
            if not p.is_file() or hashlib.sha256(p.read_bytes()).hexdigest() != digest:
                logger.warning("checkpoint %s/%d failed checksum verification at %s", family, step, rel)
                return False
        return True

    def _prune_stale_manifests(self) -> None:
        """Manifests (and step metadata) of checkpoints no longer kept."""
        live = {family: set(self.all_steps(family)) for family in ("epochs", "steps")}
        for mpath in self.directory.glob("manifest_*_*.json"):
            try:
                _, family, step = mpath.stem.split("_", 2)
                if int(step) not in live.get(family, set()):
                    mpath.unlink()
                    meta = self.directory / f"step_meta_{step}.json"
                    if family == "steps" and meta.exists():
                        meta.unlink()
            except (ValueError, OSError):
                continue

    def _restore_newest_verified(self, family: str) -> Optional[Tuple[int, Dict[str, Any]]]:
        for step in sorted(self.all_steps(family), reverse=True):
            if not self.verify_manifest(family, step):
                logger.warning(
                    "skipping corrupt %s checkpoint %d: falling back to the previous good one",
                    family, step,
                )
                continue
            return step, read_state(self._checkpoint_dir(family, step))
        return None

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        return self._restore_newest_verified("epochs")

    # -- mid-epoch step checkpoints ------------------------------------------

    def save_step(
        self, step: int, state: Dict[str, Any], metadata: Optional[Dict[str, Any]] = None
    ) -> None:
        """Commit a step checkpoint, manifest and metadata included, before
        returning (a preemption save must be on disk before the exit)."""
        self._commit("steps", step, state)
        if metadata is not None:
            atomic_write_text(
                self.directory / f"step_meta_{step}.json",
                json.dumps(metadata, indent=2, default=float),
            )

    def step_metadata(self, step: int) -> Optional[Dict[str, Any]]:
        p = self.directory / f"step_meta_{step}.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except ValueError:
            logger.warning("step metadata %s is torn/unreadable", p)
            return None

    def restore_latest_step(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        return self._restore_newest_verified("steps")

    def restore_best(self) -> Optional[Dict[str, Any]]:
        self._recover_best()
        if not self._best_dir.exists():
            return None
        return read_state(self._best_dir)


class MetricTracker:
    """Best-metric tracking and patience-based early stopping.  ``spec``
    is the signed metric string, e.g. ``"+s_f1-score"`` (higher is better)
    or ``"-loss"``."""

    def __init__(self, spec: str, patience: Optional[int] = None) -> None:
        if spec[0] not in "+-":
            raise ValueError(f"metric spec must start with +/-: {spec!r}")
        self.sign = 1.0 if spec[0] == "+" else -1.0
        self.name = spec[1:]
        self.patience = patience
        self.best: Optional[float] = None
        self.best_epoch: Optional[int] = None
        self.epochs_without_improvement = 0

    def update(self, metrics: Dict[str, float], epoch: int) -> bool:
        """True when this epoch is the new best; ``best`` keeps the raw
        metric value."""
        if self.name not in metrics:
            raise KeyError(f"validation metric {self.name!r} missing from {sorted(metrics)}")
        value = float(metrics[self.name])
        if self.best is None or self.sign * value > self.sign * self.best:
            self.best = value
            self.best_epoch = epoch
            self.epochs_without_improvement = 0
            return True
        self.epochs_without_improvement += 1
        return False

    def should_stop(self) -> bool:
        return self.patience is not None and self.epochs_without_improvement >= self.patience

    def state_dict(self) -> Dict[str, Any]:
        return {
            "best": self.best,
            "best_epoch": self.best_epoch,
            "epochs_without_improvement": self.epochs_without_improvement,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best = state["best"]
        self.best_epoch = state["best_epoch"]
        self.epochs_without_improvement = state["epochs_without_improvement"]
