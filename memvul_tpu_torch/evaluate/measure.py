"""Result-file scoring — the reference's ``cal_metrics`` contract (the JAX
package's ``evaluate/measure.py``).

``{model}_result.json`` holds one JSON line per batch, each line a list of
``{"Issue_Url", "label", "predict": {anchor: score}}`` records
(reference: predict_memory.py:159-197).  ``cal_metrics`` reduces each
record to its best anchor score, thresholds, and writes
``{model}_metric_all.json`` — byte-compatible with the reference so its
own evaluation arithmetic validates this framework's outputs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from .metrics import model_measure


def read_result_lines(path: Union[str, Path]) -> List[Dict]:
    merged: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                merged.extend(json.loads(line))
    return merged


def cal_metrics(
    result_file: Union[str, Path],
    thres: float = 0.5,
    out_file: Optional[Union[str, Path]] = None,
) -> Dict[str, float]:
    """Max-over-anchors vote, threshold at ``thres`` (validation-chosen),
    then the standard measure (reference: predict_memory.py:159-197)."""
    merged = read_result_lines(result_file)
    if not merged:
        empty = {
            "TP": 0, "FN": 0, "TN": 0, "FP": 0, "pd&recall": 0.0,
            "prec": 0.0, "f1": 0.0, "ap": 0.0, "auc": 0.0, "thres": thres,
        }
        if out_file is not None:
            Path(out_file).write_text(json.dumps(empty, indent=4))
        return empty
    labels, preds, scores = [], [], []
    for sample in merged:
        prediction = sample["predict"]
        vote = float(np.max(list(prediction.values()))) if isinstance(
            prediction, dict
        ) else float(prediction)
        labels.append(0 if sample["label"] == "neg" else 1)
        preds.append(1 if vote >= thres else 0)
        scores.append(vote)
    measured = model_measure(labels, preds, scores)
    measured["thres"] = thres
    if out_file is None:
        stem = Path(result_file)
        name = stem.name.rsplit("_", 1)[0] + "_metric_all.json"
        out_file = stem.with_name(name)
    Path(out_file).write_text(json.dumps(measured, indent=4))
    return measured
