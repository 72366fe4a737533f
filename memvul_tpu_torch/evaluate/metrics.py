"""Evaluation metrics matching the reference's arithmetic (the JAX
package's ``training/metrics.py``), in numpy.

* :func:`binary_confusion` / :func:`model_measure` — TP/FN/TN/FP with
  recall/precision/F1 plus ROC-AUC and average precision;
* :func:`find_best_threshold` — the 0.50→0.90 step-0.01 F1 sweep (ties go
  to the higher threshold);
* :class:`SiameseMeasure` — streaming (label, best-anchor probability).

:func:`roc_curve`, :func:`auc` and :func:`average_precision_score` give
scikit-learn's numbers: the ROC over distinct thresholds with collinear
points dropped, the trapezoid area, and AP as the step sum
Σ (Rₙ − Rₙ₋₁)·Pₙ.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def _binary_clf_curve(labels, scores):
    """(fps, tps, thresholds) at each distinct score, highest first."""
    y_true = np.asarray(labels).ravel() == 1
    y_score = np.asarray(scores, dtype=np.float64).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    fps, tps, thresholds = _binary_clf_curve(labels, scores)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError("x is neither increasing nor decreasing")
        direction = -1.0
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def average_precision_score(labels, scores) -> float:
    fps, tps, _ = _binary_clf_curve(labels, scores)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def binary_confusion(labels: Sequence[int], preds: Sequence[int]) -> Tuple[int, int, int, int]:
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    tn = int(((preds == 0) & (labels == 0)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    return tp, fn, tn, fp


def _prf(tp: int, fn: int, fp: int) -> Tuple[float, float, float]:
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    f1 = 2 * recall * precision / (recall + precision) if recall + precision else 0.0
    return precision, recall, f1


def model_measure(
    labels: Sequence[int], preds: Sequence[int], scores: Sequence[float]
) -> Dict[str, float]:
    """The reference's headline metric dict."""
    tp, fn, tn, fp = binary_confusion(labels, preds)
    precision, recall, f1 = _prf(tp, fn, fp)
    fpr, tpr, _ = roc_curve(labels, scores)
    return {
        "TP": tp, "FN": fn, "TN": tn, "FP": fp,
        "pd&recall": recall, "prec": precision, "f1": f1,
        "ap": average_precision_score(labels, scores), "auc": auc(fpr, tpr),
    }


def find_best_threshold(
    labels: Sequence[int],
    scores: Sequence[float],
    interval: Tuple[float, float] = (0.5, 0.9),
    step: float = 0.01,
) -> Dict[str, float]:
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    best: Optional[Dict[str, float]] = None
    best_f1 = 0.0
    for thres in np.arange(interval[0], interval[1], step):
        preds = (scores >= thres).astype(int)
        tp, fn, tn, fp = binary_confusion(labels, preds)
        precision, recall, f1 = _prf(tp, fn, fp)
        if f1 >= best_f1:
            best_f1 = f1
            best = {
                "TP": tp, "FN": fn, "TN": tn, "FP": fp,
                "precision": precision, "recall": recall, "f1": f1,
                "thres": float(thres),
            }
    return best or {
        "TP": 0, "FN": 0, "TN": 0, "FP": 0,
        "precision": 0.0, "recall": 0.0, "f1": 0.0, "thres": interval[0],
    }


class SiameseMeasure:
    """Streaming (label, best-anchor-probability) accumulator."""

    def __init__(self) -> None:
        self._labels: List[int] = []
        self._scores: List[float] = []

    def update(self, scores: Iterable[float], metas: Iterable[Dict]) -> None:
        for score, meta in zip(scores, metas):
            self._labels.append(0 if meta.get("label") == "neg" else 1)
            self._scores.append(float(score))

    def __len__(self) -> int:
        return len(self._labels)

    def compute(self, reset: bool = True) -> Dict[str, float]:
        if not self._scores:
            return {
                "precision": 0.0, "recall": 0.0, "f1": 0.0, "thres": 0.0,
                "auc": 0.0, "ave_precision_score": 0.0,
            }
        best = find_best_threshold(self._labels, self._scores)
        fpr, tpr, _ = roc_curve(self._labels, self._scores)
        out = {
            "precision": best["precision"],
            "recall": best["recall"],
            "f1": best["f1"],
            "thres": best["thres"],
            "auc": auc(fpr, tpr),
            "ave_precision_score": average_precision_score(self._labels, self._scores),
        }
        if reset:
            self.reset()
        return out

    def reset(self) -> None:
        self._labels.clear()
        self._scores.clear()
