"""The comparison that decides ``correct`` for answers checked one by one.

An answer is a report's row of per-anchor probabilities, P(same), and it is
judged in logits, ``log p - log(1 - p)``, against the reference's row.  An
answer's error is the mean over anchors of its squared gap, in logits
squared.  Nothing is taken out of the gap: a shift common to every answer
counts as much as a gap of one answer.  Nor is the gap scaled by how far
the reference's answers spread between reports: under random weights that
spread swings threefold from seed to seed while the gap a precision costs
stays put, so a scaled number would swing with the seed, not with the
program.  A report given another report's answer reads twice the
between-report variance of the answers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

P_FLOOR = 1e-7


def logits(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), P_FLOOR, 1.0 - P_FLOOR)
    return np.log(p) - np.log1p(-p)


def answer_errors(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Each sampled answer's error (``[S]``); a row with a value that is not
    finite reads infinite."""
    if program.shape != reference.shape:
        raise ValueError(f"answers of shape {program.shape} against {reference.shape}")
    finite = np.isfinite(np.asarray(program, dtype=np.float64)).all(axis=1)
    gap = logits(program) - logits(reference)
    err = (gap ** 2).mean(axis=1)
    err[~finite] = np.inf
    return err


def exactly_once(indices: np.ndarray, n_fed: int) -> int:
    """How many of the ``n_fed`` reports did not come back exactly once,
    plus any answer for a report that was never fed."""
    indices = np.asarray(indices, dtype=np.int64)
    stray = int(((indices < 0) | (indices >= n_fed)).sum())
    counts = np.bincount(indices[(indices >= 0) & (indices < n_fed)], minlength=n_fed)
    return int((counts != 1).sum()) + stray


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}
