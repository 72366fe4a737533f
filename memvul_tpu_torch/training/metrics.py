"""Training metrics (the JAX package's ``training/metrics.py``, train side).

* :func:`device_confusion` — the weighted [C, C] confusion counts of a
  step, computed on the device, so a step's metrics travel to the host as
  C² numbers instead of logits;
* :func:`drain_pending` — one host transfer for a window of per-step
  stats, where the NaN guard fires;
* :class:`RunningClassification` — streaming accuracy and per-class and
  weighted P/R/F1 from a confusion matrix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def device_confusion(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[C, C] counts (rows = true label) of the rows with nonzero weight,
    on the logits' device, without a host sync."""
    n_classes = logits.shape[-1]
    preds = logits.argmax(dim=-1).reshape(-1)
    cells = labels.reshape(-1).long() * n_classes + preds
    keep = (weights.reshape(-1) > 0).to(torch.float32)
    counts = torch.zeros(n_classes * n_classes, dtype=torch.float32, device=logits.device)
    return counts.scatter_add_(0, cells, keep).reshape(n_classes, n_classes)


def drain_pending(
    pending: List[Dict],
    fetch,
    current_step: int,
    losses: List[float],
    running: Optional["RunningClassification"] = None,
    what: str = "loss",
    extras: Optional[Dict[str, List[float]]] = None,
) -> None:
    """Pull a window of per-step stats dicts ({"loss", "confusion"[,
    ...]}) to the host through ``fetch`` in one call and fold them into
    the host accumulators.  A NaN loss raises, naming its absolute step.
    ``extras`` maps further scalar keys (``"grad_norm"``) to host lists
    they accumulate into, parallel to ``losses``."""
    if not pending:
        return
    first_step = current_step - len(pending)
    for offset, stats in enumerate(fetch(pending)):
        loss = float(stats["loss"])
        if np.isnan(loss):
            raise FloatingPointError(f"NaN {what} at step {first_step + offset}")
        losses.append(loss)
        if extras is not None:
            for key, sink in extras.items():
                if key in stats:
                    sink.append(float(stats[key]))
        if running is not None:
            running.update_confusion(stats["confusion"])
    pending.clear()


def _prf(tp: int, fn: int, fp: int):
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    f1 = 2 * recall * precision / (recall + precision) if recall + precision else 0.0
    return precision, recall, f1


class RunningClassification:
    """Streaming accuracy + per-class and weighted P/R/F1 from a confusion
    matrix (the reference's CategoricalAccuracy/FBetaMeasure trio)."""

    def __init__(self, num_classes: int, class_names: Sequence[str]) -> None:
        self.num_classes = num_classes
        self.class_names = list(class_names)
        self._cm = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update_confusion(self, confusion) -> None:
        """Merge a [C, C] count matrix (rows = true label)."""
        self._cm += np.rint(np.asarray(confusion)).astype(np.int64)

    def compute(self, reset: bool = False) -> Dict[str, float]:
        cm = self._cm
        support = cm.sum(axis=1)
        total = cm.sum()
        out: Dict[str, float] = {"accuracy": float(np.trace(cm) / total) if total else 0.0}
        per_class = []
        for i, name in enumerate(self.class_names):
            tp = cm[i, i]
            fp = cm[:, i].sum() - tp
            fn = support[i] - tp
            precision, recall, f1 = _prf(int(tp), int(fn), int(fp))
            per_class.append((precision, recall, f1))
            out[f"{name}_precision"] = precision
            out[f"{name}_recall"] = recall
            out[f"{name}_f1-score"] = f1
        if total:
            w = support / total
            out["precision"] = float(sum(w[i] * per_class[i][0] for i in range(self.num_classes)))
            out["recall"] = float(sum(w[i] * per_class[i][1] for i in range(self.num_classes)))
            out["f1-score"] = float(sum(w[i] * per_class[i][2] for i in range(self.num_classes)))
        else:
            out["precision"] = out["recall"] = out["f1-score"] = 0.0
        if reset:
            self._cm[:] = 0
        return out
