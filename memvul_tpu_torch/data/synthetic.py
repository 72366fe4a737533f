"""Synthetic corpus generation (the JAX package's ``data/synthetic.py``).

Deterministic issue-report records and a CVE dict with the reference
corpus's structure; ``realistic_lengths=True`` draws body lengths from a
lognormal with a median of about 100 words, so about 10-15% of reports
exceed 512 wordpieces — the distribution the JAX bench scores.
:func:`build_workspace` turns such a corpus into a training workspace
(splits, CVE dict, CWE anchors, a deterministic vocabulary) through the
offline pipeline, and :func:`selfcheck_config` is the tiny train config
over it.
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


def research_view_records() -> List[Dict[str, str]]:
    """A miniature CWE Research View table (shape of 1000.csv)."""
    ids = list(_CWE_NAMES)
    records = []
    for i, (cwe_id, (name, abstraction)) in enumerate(_CWE_NAMES.items()):
        parent = ids[0] if i else ""
        related = f"::NATURE:ChildOf:CWE ID:{parent}:VIEW ID:1000:ORDINAL:Primary::" if parent else ""
        records.append(
            {
                "CWE-ID": cwe_id,
                "Name": name,
                "Weakness Abstraction": abstraction,
                "Description": f"The product mishandles {name.lower()} conditions.",
                "Extended Description": f"Extended notes about {name.lower()}.",
                "Common Consequences": "::SCOPE:Integrity:IMPACT:Execute Unauthorized Code or Commands::",
                "Related Weaknesses": related,
            }
        )
    return records


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


def selfcheck_config(ws, **trainer_overrides):
    """A tiny reference-shaped train config over a :func:`build_workspace`
    artifact set, the geometry that trains in seconds on the CPU while
    exercising every layer: reader pair sampling, the Siamese train step,
    threshold-swept validation, archiving."""
    trainer = {
        "num_epochs": 1,
        "patience": 2,
        "batch_size": 4,
        "grad_accum": 2,
        "max_length": 48,
        "eval_batch_size": 8,
        "eval_max_length": 48,
        "warmup_steps": 2,
        "steps_per_epoch": 3,
    }
    trainer.update(trainer_overrides)
    return {
        "random_seed": 2021,
        "tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
        "dataset_reader": {
            "type": "reader_memory",
            "sample_neg": 1.0,
            "same_diff_ratio": {"same": 2, "diff": 2},
            "cve_path": ws["paths"]["cve"],
            "anchor_path": ws["paths"]["anchors"],
        },
        "train_data_path": ws["paths"]["train"],
        "validation_data_path": ws["paths"]["validation"],
        "model": {
            "type": "model_memory",
            "encoder": {"preset": "tiny", "vocab_size": 4096},
            "use_header": True,
            "header_dim": 32,
            "temperature": 0.1,
        },
        "trainer": trainer,
        "evaluation": {"batch_size": 8, "max_length": 48},
    }


def build_workspace(tmp_dir, seed: int = 0, **corpus_kwargs):
    """Materialize a full artifact set under ``tmp_dir``: train/validation/
    test JSON splits, CVE dict, anchors, and a trained tokenizer.  Returns a
    dict of paths plus in-memory objects."""
    import json
    from pathlib import Path

    from .corpus import preprocess, split_by_project, write_json
    from .cwe import build_anchors, build_cwe_tree, cwe_distribution
    from .tokenizer import WordPieceTokenizer

    tmp = Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    reports, cve_dict = generate_corpus(seed=seed, **corpus_kwargs)
    clean = preprocess(reports)
    train, test = split_by_project(clean, held_out_frac=0.25, seed=seed)
    train, validation = split_by_project(train, held_out_frac=0.25, seed=seed + 1)

    tree = build_cwe_tree(research_view_records())
    positives = [r for r in train if r["Security_Issue_Full"] == "1"]
    for r in positives:
        r["CWE_ID"] = cve_dict[r["CVE_ID"]]["CWE_ID"]
    dist = cwe_distribution(positives, cve_dict)
    anchors = build_anchors(dist, tree, cve_dict, seed=seed)

    paths = {
        "train": tmp / "train_project.json",
        "validation": tmp / "validation_project.json",
        "test": tmp / "test_project.json",
        "cve": tmp / "CVE_dict.json",
        "anchors": tmp / "CWE_anchor_golden_project.json",
        "tokenizer": tmp / "tokenizer.json",
    }
    write_json(train, paths["train"])
    write_json(validation, paths["validation"])
    write_json(test, paths["test"])
    paths["cve"].write_text(json.dumps(cve_dict))
    paths["anchors"].write_text(json.dumps(anchors))

    texts = corpus_texts(reports) + [a for a in anchors.values()]
    # a deterministic vocabulary: the same artifacts from the same seed
    tokenizer = WordPieceTokenizer.build_deterministic(
        texts, vocab_size=2048, save_path=paths["tokenizer"]
    )
    return {
        "paths": {k: str(v) for k, v in paths.items()},
        "tokenizer": tokenizer,
        "anchors": anchors,
        "cve_dict": cve_dict,
        "splits": {"train": train, "validation": validation, "test": test},
    }
