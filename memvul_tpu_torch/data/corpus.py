"""Offline corpus pipeline (the JAX package's ``data/corpus.py``):
cleaning, leak guards and project-level splits.

1. drop reports missing both title and body;
2. drop positives created at or after their CVE's public disclosure (the
   temporal leak guard);
3. drop projects left without any positive;
4. normalize title and body text (:func:`~.native.normalize_batch`, whose
   specification is :func:`~.normalize.normalize_text`);
5. split by project, not by report.

Plain lists of dicts, one per issue report.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union


def extract_project(issue_url: str) -> str:
    """``https://github.com/<owner>/<repo>/issues/<n>`` → ``owner/repo``."""
    parts = issue_url.split("/")
    if len(parts) != 7:
        return "ERROR"
    return f"{parts[3]}/{parts[4]}"


def _is_positive(sample: Dict, target: str) -> bool:
    return str(sample.get(target, "0")) in ("1", "1.0")


def preprocess(
    samples: Iterable[Dict],
    target: str = "Security_Issue_Full",
    normalize: bool = True,
) -> List[Dict]:
    """Clean the raw corpus (steps 1-4 above). Returns new record dicts."""
    kept: List[Dict] = []
    for s in samples:
        title, body = s.get("Issue_Title"), s.get("Issue_Body")
        if not title and not body:
            continue
        if _is_positive(s, target):
            created = s.get("Issue_Created_At") or ""
            published = s.get("Published_Date") or ""
            if created and published and str(created) >= str(published):
                continue  # temporal leak guard: filed after CVE disclosure
        rec = dict(s)
        rec["project"] = extract_project(s.get("Issue_Url", ""))
        kept.append(rec)

    by_project: Dict[str, int] = defaultdict(int)
    for rec in kept:
        by_project[rec["project"]] += _is_positive(rec, target)
    kept = [rec for rec in kept if by_project[rec["project"]] > 0]

    if normalize:
        # batch through the parity-checked native normalizer when it builds
        # (a thread pool over documents), else the Python pass table
        from .native import normalize_batch

        titles = normalize_batch([rec.get("Issue_Title") or "" for rec in kept])
        bodies = normalize_batch([rec.get("Issue_Body") or "" for rec in kept])
        for rec, title, body in zip(kept, titles, bodies):
            rec["Issue_Title"] = title
            rec["Issue_Body"] = body
    return kept


def split_by_project(
    samples: Sequence[Dict],
    held_out_frac: float = 0.1,
    seed: Optional[int] = None,
) -> Tuple[List[Dict], List[Dict]]:
    """Project-level split: a fraction of the *projects* (sorted, then
    sampled from ``seed``) is held out."""
    rng = random.Random(seed)
    keys = [
        s.get("project") or extract_project(s.get("Issue_Url", "")) for s in samples
    ]
    projects = sorted(set(keys))
    held = set(rng.sample(projects, k=int(len(projects) * held_out_frac)))
    train = [s for s, k in zip(samples, keys) if k not in held]
    test = [s for s, k in zip(samples, keys) if k in held]
    return train, test


def write_json(samples: Sequence[Dict], path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(list(samples), indent=1))


def load_json(path: Union[str, Path]) -> List[Dict]:
    return json.loads(Path(path).read_text())


def write_mlm_corpus(samples: Iterable[Dict], path: Union[str, Path]) -> int:
    """One report a line ("title. body") for MLM further pretraining;
    returns the line count."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for s in samples:
            line = f"{s.get('Issue_Title') or ''}. {s.get('Issue_Body') or ''}".strip()
            if line != ".":
                f.write(line.replace("\n", " ") + "\n")
                n += 1
    return n
