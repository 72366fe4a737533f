"""Corpus JSON → instance streams (the JAX package's ``data/readers.py``).

Instance = a plain dict: ``text1`` (the issue report, or an anchor
description), ``text2`` (the pair partner, training only), ``label``
("same"/"diff") and ``meta`` ({"type", "label", "Issue_Url"}, carried to
the metrics and the output file).  :class:`MemoryReader` streams
test/validation corpora as scoring instances, the golden file as the
anchor bank, and the training corpus as Siamese pairs with online
sampling: every positive pairs with its own CVE description plus
``same - 1`` same-CWE partners (partner text: 70% the partner's CVE
description, 15% its CWE anchor, 15% the partner report); each negative
survives with probability ``sample_neg`` and pairs with ``diff`` random
anchors.  The pair stream draws from one ``random.Random`` in the JAX
reader's order, so both readers give the same pairs for the same seed.
The split comes from an explicit ``split=`` or, failing that, from the
file name ("golden"/"test_"/"validation_").  Scoring streams take a
``quarantine`` (:class:`~memvul_tpu_torch.resilience.journal.DeadLetter`):
a record that does not parse, fails to prepare or is over-long is
dead-lettered with its reason and the stream goes on; without one such a
record raises, and training keeps that fail-fast rule.  The chaos fault
points belong to slice 11.  :class:`SingleReader` streams
single-text instances for the MemVul-m and TextCNN classifiers.
"""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from .normalize import normalize_text

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


def _iter_corpus(file_path: str, quarantine=None) -> Iterator[Dict]:
    """Raw sample dicts: ``.jsonl`` streams one record per line, a ``.json``
    array loads at once.  With a ``quarantine`` a ``.jsonl`` line that does
    not parse is dead-lettered and skipped; without one it raises."""
    if str(file_path).endswith(".jsonl"):
        with open(file_path, encoding="utf-8") as f:
            for lineno, line in enumerate(f):
                if not line.strip():
                    continue
                try:
                    record = json.loads(line)
                except ValueError as e:
                    if quarantine is None:
                        raise
                    quarantine.record(f"line {lineno}: {type(e).__name__}: {e}", raw=line)
                    continue
                yield record
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
        self._target = target
        self._ratio = same_diff_ratio or {"same": 2, "diff": 6}
        self._sample_neg = sample_neg
        self._train_iter = train_iter
        self._rng = random.Random(seed)
        self._cve: Dict[str, Dict] = {}
        self._anchors: Dict[str, str] = {}
        if cve_path:
            self._cve = json.loads(Path(cve_path).read_text())
        if anchor_path:
            self._anchors = json.loads(Path(anchor_path).read_text())
        self._grouped_cache: Dict[str, Dict[str, List[Dict]]] = {}

    def reseed(self, seed: int) -> None:
        """Re-seed the pair-sampling RNG.  The trainer calls this at every
        epoch start, so each epoch's pair stream is a pure function of
        (trainer seed, epoch index) and a resumed run replays it."""
        self._rng.seed(seed)

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

    def _cve_description(self, cve_id: str) -> str:
        """A CVE description, tag-normalized once."""
        rec = self._cve[cve_id]
        if not rec.get("_normalized"):
            rec["CVE_Description"] = normalize_text(rec.get("CVE_Description") or "")
            rec["_normalized"] = True
        return rec["CVE_Description"]

    def group_by_cwe(self, file_path: str) -> Dict[str, List[Dict]]:
        """Load a corpus file and bucket its samples: negatives under
        "neg", positives under their CWE category (cached per path)."""
        if file_path in self._grouped_cache:
            return self._grouped_cache[file_path]
        grouped: Dict[str, List[Dict]] = {"neg": []}
        for s in _iter_corpus(file_path):
            s = self._prepare_sample(s)
            if s is None:
                continue
            if s[self._target] == "pos":
                grouped.setdefault(s["CWE_ID"], []).append(s)
            else:
                grouped["neg"].append(s)
        self._grouped_cache[file_path] = grouped
        return grouped

    def read(
        self, file_path: str, split: Optional[str] = None, quarantine=None
    ) -> Iterator[Dict]:
        split = split or detect_split(file_path)
        if split == GOLDEN:
            yield from self.read_anchors(file_path)
            return
        if split not in (TEST, VALIDATION, UNLABEL):
            # pair generation looks up same-CWE partners: grouped corpus
            yield from self._train_pairs(self.group_by_cwe(file_path))
            return
        # test corpora stream as unlabeled scoring instances, validation
        # as labeled "test" instances; a grouped corpus is reused
        mode = "test" if split == VALIDATION else UNLABEL
        count = 0
        if file_path in self._grouped_cache:
            samples = (
                s for bucket in self._grouped_cache[file_path].values() for s in bucket
            )
        else:
            samples = self._prepared_stream(file_path, quarantine)
        for s in samples:
            if quarantine is not None and len(s.get("text") or "") > quarantine.max_text_chars:
                quarantine.record(
                    f"over-long text ({len(s['text'])} chars > {quarantine.max_text_chars} cap)",
                    meta={"Issue_Url": s.get("Issue_Url")},
                )
                continue
            count += 1
            yield self._eval_instance(s, mode)
        logger.info("%s: %d evaluation instances", file_path, count)

    def _prepared_stream(self, file_path: str, quarantine) -> Iterator[Dict]:
        for s in _iter_corpus(file_path, quarantine=quarantine):
            try:
                prepared = self._prepare_sample(s)
            except Exception as e:
                if quarantine is None:
                    raise
                quarantine.record(
                    f"prepare failed: {type(e).__name__}: {e}",
                    meta={"Issue_Url": s.get("Issue_Url")} if isinstance(s, dict) else None,
                )
                continue
            if prepared is not None:
                yield prepared

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

    def _train_pairs(self, grouped: Dict[str, List[Dict]]) -> Iterator[Dict]:
        all_data = [s for bucket in grouped.values() for s in bucket]
        self._rng.shuffle(all_data)
        anchor_ids = list(self._anchors.keys())
        same_k, diff_k = self._ratio["same"], self._ratio["diff"]
        rng = self._rng
        same_num = diff_num = 0
        for _ in range(self._train_iter):
            for s in all_data:
                if s[self._target] == "pos":
                    yield self._pair_instance(s, s)
                    partners = grouped[s["CWE_ID"]]
                    for partner in rng.choices(partners, k=same_k - 1):
                        yield self._pair_instance(s, partner)
                    same_num += same_k
                elif rng.random() < self._sample_neg:
                    for category in rng.choices(anchor_ids, k=diff_k):
                        yield self._anchor_pair_instance(s, category)
                    diff_num += diff_k
        logger.info("pair counts: same=%d diff=%d", same_num, diff_num)

    def _partner_text(self, s: Dict, partner: Dict) -> str:
        """The matched pair's second text."""
        rng = self._rng
        if s["Issue_Url"] == partner["Issue_Url"]:
            return self._cve_description(partner["CVE_ID"])
        if rng.random() < 0.7:
            return self._cve_description(partner["CVE_ID"])
        if rng.random() < 0.5:
            category = partner.get("CWE_ID")
            if category is not None and category in self._anchors:
                return self._anchors[category]
            return partner["text"]
        return partner["text"]

    def _pair_instance(self, s: Dict, partner: Dict) -> Dict:
        return {
            "text1": s["text"],
            "text2": self._partner_text(s, partner),
            "label": "same",
            "meta": {"type": TRAIN, "label": s["CWE_ID"], "Issue_Url": s["Issue_Url"]},
        }

    def _anchor_pair_instance(self, s: Dict, category: str) -> Dict:
        return {
            "text1": s["text"],
            "text2": self._anchors[category],
            "label": "diff",
            "meta": {"type": TRAIN, "label": "neg", "Issue_Url": s.get("Issue_Url")},
        }


class SingleReader:
    """The single-text classifiers' reader (MemVul-m, TextCNN): each
    report as ``text1`` = "title. body" with a "pos"/"neg" label from
    ``target``.  On the train split a negative survives with probability
    ``sample_neg`` (None keeps all), drawn from one ``random.Random(seed)``
    in the JAX reader's order, so re-reading the file re-subsamples the
    negatives and both readers give the same stream for the same seed."""

    def __init__(
        self,
        sample_neg: Optional[float] = None,
        target: str = "Security_Issue_Full",
        seed: Optional[int] = None,
    ) -> None:
        self._target = target
        self._sample_neg = sample_neg
        self._rng = random.Random(seed)

    def read(self, file_path: str, split: Optional[str] = None) -> Iterator[Dict]:
        split = split or detect_split(file_path)
        for s in _iter_corpus(file_path):
            positive = str(s.get(self._target)) in ("1", "1.0", "pos")
            if (
                split == TRAIN
                and not positive
                and self._sample_neg is not None
                and self._rng.random() >= self._sample_neg
            ):
                continue
            label = "pos" if positive else "neg"
            yield {
                "text1": f"{s.get('Issue_Title') or ''}. {s.get('Issue_Body') or ''}",
                "label": label,
                "meta": {"type": split, "label": label, "Issue_Url": s.get("Issue_Url")},
            }
