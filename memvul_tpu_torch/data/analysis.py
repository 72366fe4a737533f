"""Paper-analysis utilities over the corpus (the JAX package's
``data/analysis.py``; pure functions, no I/O).

The security-keyword study, the report-to-CVE-disclosure delay histogram,
the positive-report/CVE join and the per-CWE distribution with its
cumulative form, the attack-steps (PoC) count and the repository star/fork
statistics of the MemVul paper's analysis scripts.  Each returns plain data;
``python -m memvul_tpu_torch analyze`` prints them as one JSON report.
"""

from __future__ import annotations

import re
from datetime import datetime
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .corpus import extract_project

# the paper's security-keyword lexicon (reference: utils.py:443); a match
# in title or body marks a report as "security-flagged" for the
# keyword-baseline comparison
SECURITY_KEYWORD_RE = re.compile(
    r"(?i)(denial.of.service|\bxxe\b|remote.code.execution|\bopen.redirect"
    r"|osvdb|\bvuln|\bcve\b|\bxss\b|\bredos\b|\bnvd\b|malicious"
    r"|x−frame−options|attack|cross.site|exploit|directory.traversal"
    r"|\brce\b|\bdos\b|\bxsrf\b|clickjack|session.fixation|hijack|advisory"
    r"|insecure|security|\bcross−origin\b|unauthori[z|s]ed|infinite.loop"
    r"|authenticat(e|ion)|bruteforce|bypass|constant.time|crack|credential"
    r"|expos(e|ing)|hack|harden|injection|lockout|overflow|password"
    r"|\bpoc\b|proof.of.concept|poison|privelage|\b(in)?secur(e|ity)"
    r"|(de)?serializ|spoof|timing|traversal)"
)

# PoC / reproduction-steps markers (reference: utils.py:560 — no right \b
# so "PoCs" matches; leading (n)? because of literal "\nPoC" artifacts)
ATTACK_STEPS_RE = re.compile(
    r"(?i)(\b(n)?poc|proof-of-concept|proof\sof\sconcept"
    r"|steps\sto\sreproduce|steps\sto\sreplicate)"
)

DELTA_DAY_BINS = ((None, 0.0), (0.0, 7.0), (7.0, 30.0), (30.0, 180.0), (180.0, None))
DELTA_DAY_LABELS = ["(-inf,0]", "(0,7]", "(7,30]", "(30,180]", "(180,+inf)"]


def _is_positive(sample: Dict, target: str) -> bool:
    return str(sample.get(target, "0")) in ("1", "1.0", "pos")


def matches_security_keyword(text: Optional[str]) -> bool:
    return bool(SECURITY_KEYWORD_RE.search(text or ""))


def keyword_match_study(
    samples: Iterable[Dict], target: str = "Security_Issue_Full"
) -> Dict[str, int]:
    """The preliminary study: how well does naive keyword matching separate
    dangerous reports?  Counts the 2×2 of (positive?, keyword in title or
    body?) (reference: utils.py:450-466)."""
    counts = {"pos_match": 0, "pos_not_match": 0, "neg_match": 0, "neg_not_match": 0}
    for s in samples:
        matched = matches_security_keyword(
            s.get("Issue_Title")
        ) or matches_security_keyword(s.get("Issue_Body"))
        key = ("pos" if _is_positive(s, target) else "neg") + (
            "_match" if matched else "_not_match"
        )
        counts[key] += 1
    return counts


def fix_timestamp(t: str) -> str:
    """Normalize ``"2018-10-30 16:26:01 UTC"``-style stamps to ISO-Z
    (reference: utils.py:41-46)."""
    t = t.strip()
    t = re.sub(r"\sUTC", "Z", t)
    return re.sub(r"\s", "T", t)


def _parse_time(t: str) -> datetime:
    t = fix_timestamp(t)
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%MZ", "%Y-%m-%d"):
        try:
            return datetime.strptime(t, fmt)
        except ValueError:
            continue
    raise ValueError(f"unparseable timestamp {t!r}")


def delta_days_histogram(
    positives: Iterable[Dict],
    cve_dict: Optional[Dict[str, Dict]] = None,
) -> Dict[str, object]:
    """Histogram of (CVE disclosure − IR creation) in days over the bins
    (-inf,0], (0,7], (7,30], (30,180], (180,+inf)
    (reference: utils.py:470-512).  ``Published_Date`` is read off the
    record, falling back to the CVE dict."""
    counts = [0] * len(DELTA_DAY_BINS)
    total = 0
    for s in positives:
        created = s.get("Issue_Created_At") or ""
        published = s.get("Published_Date") or ""
        if not published and cve_dict:
            published = (cve_dict.get(s.get("CVE_ID")) or {}).get("Published_Date", "")
        if not created or not published:
            continue
        delta = _parse_time(published) - _parse_time(created)
        delta_days = delta.days + delta.seconds / 86400.0
        for i, (lo, hi) in enumerate(DELTA_DAY_BINS):
            if (lo is None or delta_days > lo) and (hi is None or delta_days <= hi):
                counts[i] += 1
                break
        total += 1
    fractions = [c / total if total else 0.0 for c in counts]
    return {"labels": list(DELTA_DAY_LABELS), "counts": counts,
            "fractions": fractions, "total": total}


def join_positives_with_cve(
    samples: Iterable[Dict],
    cve_dict: Dict[str, Dict],
    target: str = "Security_Issue_Full",
) -> List[Dict]:
    """All positive reports with their CWE id + CVE description attached
    (the reference's ``pos_info.json``, utils.py:186-205)."""
    out = []
    for s in samples:
        if not _is_positive(s, target):
            continue
        rec = dict(s)
        cve = cve_dict.get(s.get("CVE_ID")) or {}
        rec["CWE_ID"] = cve.get("CWE_ID")
        rec["CVE_Description"] = cve.get("CVE_Description")
        out.append(rec)
    return out


def cwe_report_distribution(
    pos_info: Iterable[Dict],
    cwe_tree: Optional[Dict[str, Dict]] = None,
) -> Dict[str, Dict]:
    """Per-CWE-category report/CVE counts — the reference's
    ``CWE_distribution.json`` shape (utils.py:208-235): each entry carries
    ``abstraction`` (from the Research View when resolvable),
    ``#issue report``, ``#CVE`` and a per-CVE report count.  The special
    categories NVD-CWE-noinfo / NVD-CWE-Other / null stay unresolved."""
    dist: Dict[str, Dict] = {}
    for pos in pos_info:
        cve_id = pos.get("CVE_ID")
        cwe_id = pos.get("CWE_ID") or "null"
        entry = dist.get(cwe_id)
        if entry is None:
            entry = dist[cwe_id] = {
                "abstraction": None,
                "#issue report": 0,
                "#CVE": 0,
                "CVE_distribution": {},
            }
            if cwe_id not in ("NVD-CWE-noinfo", "NVD-CWE-Other", "null") and cwe_tree:
                bare = cwe_id.split("-")[-1]
                node = cwe_tree.get(bare)
                if node is not None:
                    entry["abstraction"] = node.get("Weakness Abstraction")
        entry["#issue report"] += 1
        if cve_id not in entry["CVE_distribution"]:
            entry["CVE_distribution"][cve_id] = 0
            entry["#CVE"] += 1
        entry["CVE_distribution"][cve_id] += 1
    return dist


def cumulative_cwe_distribution(
    cwe_distribution: Dict[str, Dict]
) -> List[Tuple[int, float]]:
    """ECDF of category size: (reports-per-CWE, fraction of CWE categories
    with at most that many reports) (reference: utils.py:515-541)."""
    sizes = sorted(v["#issue report"] for v in cwe_distribution.values())
    if not sizes:
        return []
    points: List[Tuple[int, float]] = []
    n = len(sizes)
    for i, size in enumerate(sizes):
        if i + 1 == n or sizes[i + 1] != size:
            points.append((size, (i + 1) / n))
    return points


def count_attack_steps(
    positives: Iterable[Dict], field: str = "Issue_Body"
) -> Dict[str, int]:
    """How many dangerous reports include reproduction/PoC steps
    (reference: utils.py:544-572; paper rebuttal: 1,570 of 3,937)."""
    total = 0
    with_steps = 0
    for s in positives:
        total += 1
        if ATTACK_STEPS_RE.search(s.get(field) or ""):
            with_steps += 1
    return {"total": total, "with_attack_steps": with_steps}


def repo_stats(
    samples: Iterable[Dict], repo_info: Dict[str, Dict]
) -> Dict[str, object]:
    """Median/mean star/watch/fork/subscriber counts over the corpus's
    projects (reference: utils.py:415-439).  Projects missing from
    ``repo_info`` are reported, not dropped silently."""
    import numpy as np

    projects = {
        s.get("project") or extract_project(s.get("Issue_Url", "")) for s in samples
    }
    projects.discard("ERROR")
    missing = sorted(projects - set(repo_info))
    found = sorted(projects & set(repo_info))
    out: Dict[str, object] = {
        "num_projects": len(projects),
        "missing_projects": missing,
    }
    for key, name in (
        ("stargazers_count", "star"),
        ("watchers_count", "watch"),
        ("forks_count", "fork"),
        ("subscribers_count", "subscribe"),
    ):
        values = [repo_info[p].get(key, 0) for p in found]
        out[name] = {
            "median": float(np.median(values)) if values else 0.0,
            "mean": float(np.mean(values)) if values else 0.0,
        }
    return out
