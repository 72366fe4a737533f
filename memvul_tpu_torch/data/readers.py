"""Corpus JSON → evaluation instance streams (the scoring path of the JAX
package's ``data/readers.py``).

Instance = a plain dict: ``text1`` (the issue report, or an anchor
description), ``label`` ("same"/"diff") and ``meta`` ({"type", "label",
"Issue_Url"}, carried to the metrics and the output file).
:class:`MemoryReader` streams test/validation corpora as scoring
instances and the golden file as the anchor bank.  The split comes from
an explicit ``split=`` or, failing that, from the file name
("golden"/"test_"/"validation_").  Training-pair generation, fault points
and quarantine belong to later slices.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)

TRAIN, VALIDATION, TEST, GOLDEN, UNLABEL = (
    "train", "validation", "test", "golden", "unlabel",
)


def detect_split(file_path: str) -> str:
    name = str(file_path)
    if "golden" in name:
        return GOLDEN
    if "test_" in name:
        return TEST
    if "validation_" in name:
        return VALIDATION
    return TRAIN


def _iter_corpus(file_path: str) -> Iterator[Dict]:
    """Raw sample dicts: ``.jsonl`` streams one record per line, a ``.json``
    array loads at once."""
    if str(file_path).endswith(".jsonl"):
        with open(file_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)
    else:
        yield from json.loads(Path(file_path).read_text())


class MemoryReader:
    def __init__(
        self,
        cve_path: Optional[str] = None,
        anchor_path: Optional[str] = None,
        same_diff_ratio: Optional[Dict[str, int]] = None,
        sample_neg: float = 0.1,
        train_iter: int = 1,
        target: str = "Security_Issue_Full",
        seed: Optional[int] = None,
    ) -> None:
        # same_diff_ratio / sample_neg / train_iter / seed configure the
        # training pair stream: accepted so a training config's reader
        # section loads, unused until training is ported
        self._target = target
        self._cve: Dict[str, Dict] = {}
        self._anchors: Dict[str, str] = {}
        if cve_path:
            self._cve = json.loads(Path(cve_path).read_text())
        if anchor_path:
            self._anchors = json.loads(Path(anchor_path).read_text())

    def _prepare_sample(self, s: Dict) -> Optional[Dict]:
        """Concatenated text, pos/neg target, CWE via the CVE record; None
        for a positive without a CWE (dirty data the reference drops)."""
        s["text"] = f"{s.get('Issue_Title') or ''}. {s.get('Issue_Body') or ''}"
        if str(s.get(self._target)) in ("1", "1.0"):
            cwe_id = s.get("CWE_ID") or self._cve.get(s.get("CVE_ID"), {}).get("CWE_ID")
            if cwe_id is None:
                return None
            s[self._target] = "pos"
            s["CWE_ID"] = cwe_id
        else:
            s[self._target] = "neg"
        return s

    def read(self, file_path: str, split: Optional[str] = None) -> Iterator[Dict]:
        split = split or detect_split(file_path)
        if split == GOLDEN:
            yield from self.read_anchors(file_path)
            return
        if split not in (TEST, VALIDATION, UNLABEL):
            raise NotImplementedError(
                f"split {split!r}: training pair streams are not ported yet"
            )
        # test corpora stream as unlabeled scoring instances, validation
        # as labeled "test" instances
        mode = "test" if split == VALIDATION else UNLABEL
        count = 0
        for s in _iter_corpus(file_path):
            s = self._prepare_sample(s)
            if s is None:
                continue
            count += 1
            yield self._eval_instance(s, mode)
        logger.info("%s: %d evaluation instances", file_path, count)

    def read_anchors(self, anchor_path: Optional[str] = None) -> Iterator[Dict]:
        anchors = (
            json.loads(Path(anchor_path).read_text()) if anchor_path else self._anchors
        )
        for category, description in anchors.items():
            yield {
                "text1": description,
                "label": "same",
                "meta": {"type": GOLDEN, "label": category},
            }

    def _eval_instance(self, s: Dict, mode: str) -> Dict:
        positive = s[self._target] == "pos"
        return {
            "text1": s["text"],
            "label": "same" if positive else "diff",
            "meta": {
                "type": mode,
                "label": s.get("CWE_ID") if positive else "neg",
                "Issue_Url": s.get("Issue_Url"),
            },
        }
