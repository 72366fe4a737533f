"""Synthetic corpus generation (the JAX package's ``data/synthetic.py``).

Deterministic issue-report records and a CVE dict with the reference
corpus's structure; ``realistic_lengths=True`` draws body lengths from a
lognormal with a median of about 100 words, so about 10-15% of reports
exceed 512 wordpieces — the distribution the JAX bench scores.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

_VULN_PHRASES = [
    "buffer overflow in the parser allows remote attackers to execute code",
    "improper neutralization of input during web page generation",
    "sql injection vulnerability in the login form",
    "use after free in the renderer leads to memory corruption",
    "path traversal lets attackers read arbitrary files",
    "cross site scripting in the comment field",
    "integer overflow when decoding the length header",
    "improper authentication allows session hijacking",
]

_BENIGN_PHRASES = [
    "the build fails on windows with a linker warning",
    "documentation typo in the install guide",
    "feature request add dark mode to the settings page",
    "tests are flaky on slow machines please increase the timeout",
    "the cli prints a confusing message when the config file is missing",
    "performance regression after upgrading the compiler",
    "crash on startup when the cache directory is empty",
    "please support python three point twelve",
]

_CWE_NAMES = {
    "79": ("Cross-site Scripting", "Class"),
    "89": ("SQL Injection", "Base"),
    "119": ("Improper Restriction of Operations within the Bounds of a Memory Buffer", "Class"),
    "416": ("Use After Free", "Variant"),
    "22": ("Path Traversal", "Base"),
    "190": ("Integer Overflow or Wraparound", "Base"),
    "287": ("Improper Authentication", "Class"),
    "787": ("Out-of-bounds Write", "Base"),
}


def _body_with_length(rng: random.Random, phrases: List[str], base: str) -> str:
    """Compose an issue body with a long-tailed word count, mimicking real
    GitHub issues: lognormal with median ~100 words (≈130 wordpieces),
    ~10-15% of reports exceeding the 512-wordpiece eval cap — so the
    bucketed batcher sees a realistic mix rather than uniform shorts."""
    target = int(rng.lognormvariate(4.6, 1.0))  # median e^4.6 ≈ 100 words
    target = max(5, min(target, 2000))
    parts = [base]
    words = len(base.split())
    while words < target:
        p = rng.choice(phrases)
        parts.append(p)
        words += len(p.split())
    return " ".join(parts)


def generate_corpus(
    num_projects: int = 8,
    reports_per_project: int = 24,
    positive_rate: float = 0.25,
    seed: int = 0,
    realistic_lengths: bool = False,
) -> Tuple[List[Dict], Dict[str, Dict]]:
    """Build (issue_reports, cve_dict)."""
    rng = random.Random(seed)
    cwe_ids = list(_CWE_NAMES)
    reports: List[Dict] = []
    cve_dict: Dict[str, Dict] = {}
    cve_counter = 0
    for p in range(num_projects):
        project = f"org{p}/repo{p}"
        for i in range(reports_per_project):
            url = f"https://github.com/{project}/issues/{i}"
            positive = rng.random() < positive_rate or i == 0  # ≥1 CIR per project
            if positive:
                cve_counter += 1
                cve_id = f"CVE-2021-{10000 + cve_counter}"
                cwe = rng.choice(cwe_ids)
                phrase = rng.choice(_VULN_PHRASES)
                cve_dict[cve_id] = {
                    "CVE_ID": cve_id,
                    "CWE_ID": f"CWE-{cwe}",
                    "CVE_Description": f"{phrase} in project {project}",
                }
                body = f"{phrase} affecting version NUMBERTAG"
                if realistic_lengths:
                    body = _body_with_length(rng, _VULN_PHRASES, body)
                reports.append(
                    {
                        "Issue_Url": url,
                        "Issue_Title": f"security report {i}",
                        "Issue_Body": body,
                        "Security_Issue_Full": "1",
                        "CVE_ID": cve_id,
                        "Issue_Created_At": "2021-01-01T00:00:00Z",
                        "Published_Date": "2021-06-01T00:00:00Z",
                    }
                )
            else:
                body = rng.choice(_BENIGN_PHRASES)
                if realistic_lengths:
                    body = _body_with_length(rng, _BENIGN_PHRASES, body)
                reports.append(
                    {
                        "Issue_Url": url,
                        "Issue_Title": f"issue {i}",
                        "Issue_Body": body,
                        "Security_Issue_Full": "0",
                        "CVE_ID": "",
                        "Issue_Created_At": "2021-01-01T00:00:00Z",
                        "Published_Date": "",
                    }
                )
    return reports, cve_dict


def corpus_texts(reports: List[Dict]) -> List[str]:
    return [f"{r['Issue_Title']}. {r['Issue_Body']}" for r in reports]
