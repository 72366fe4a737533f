"""CWE Research-View graph and external-memory anchor construction (the
JAX package's ``data/cwe.py``).

One natural-language anchor description per CWE category observed in the
training split: over a BFS subtree of the Research View rooted at the CWE
(level 1 by default, abstraction-ranked), each member's name,
description, consequence impacts and extended description, then a few
sampled member-CVE descriptions.  CWEs outside the view fall back to CVE
descriptions alone.  Edges come from ``Related Weaknesses`` restricted to
VIEW 1000: ChildOf/ParentOf → father/children, PeerOf/CanAlsoBe → peer,
CanPrecede/Requires → relate.
"""

from __future__ import annotations

import csv
import json
import random
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

from ..resilience.io import atomic_write_text
from .normalize import normalize_text

# ordering used to put high-level categories before specific ones
ABSTRACTION_RANK = {"Pillar": 1, "Class": 2, "Base": 2.5, "Variant": 3, "Compound": 3}


def load_research_view_csv(path: Union[str, Path]) -> List[Dict[str, str]]:
    """The CWE Research View export (1000.csv) as record dicts."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def build_cwe_tree(records: Iterable[Dict[str, str]]) -> Dict[str, Dict]:
    """Link CWE records into a graph keyed by the bare numeric id (str)."""
    tree: Dict[str, Dict] = {}
    for rec in records:
        node = dict(rec)
        node.update(father=[], children=[], peer=[], relate=[])
        tree[str(rec["CWE-ID"])] = node

    for cwe_id, node in tree.items():
        for rel in (node.get("Related Weaknesses") or "").split("::"):
            if "VIEW ID:1000" not in rel:
                continue
            parts = rel.split(":")
            try:
                target = str(int(parts[3]))
            except (IndexError, ValueError):
                continue
            if target not in tree:
                continue
            if "ChildOf" in parts:
                node["father"].append(target)
                tree[target]["children"].append(cwe_id)
            elif "PeerOf" in parts or "CanAlsoBe" in parts:
                node["peer"].append(target)
                tree[target]["peer"].append(cwe_id)
            elif "CanPrecede" in parts or "Requires" in parts:
                node["relate"].append(target)
                tree[target]["relate"].append(cwe_id)
    return tree


def bfs_subtree(tree: Dict[str, Dict], root: str, level: int = 1) -> List[str]:
    """Collect ids reachable from ``root`` within ``level`` hops (children,
    peers and related nodes all count as neighbors), root first, BFS order,
    deduplicated keeping first occurrence."""
    seen: List[str] = []
    frontier = [str(root)]
    for _ in range(level + 1):
        nxt: List[str] = []
        for node_id in frontier:
            if node_id not in tree:
                continue
            if node_id not in seen:
                seen.append(node_id)
            node = tree[node_id]
            nxt.extend(str(x) for x in node["children"] + node["peer"] + node["relate"])
        if not nxt:
            break
        frontier = nxt
    return seen


def _with_period(s: str) -> str:
    s = (s or "").strip()
    if not s:
        return s
    if not s.endswith("."):
        s += "."
    return s + " "


def _consequence_impacts(common_consequences: str) -> List[str]:
    """Extract IMPACT values from the ``::``-packed Common Consequences
    field (reference: utils.py:288-295)."""
    impacts: List[str] = []
    for item in (common_consequences or "").split("::"):
        if "SCOPE" not in item:
            continue
        grab = False
        for element in item.split(":"):
            if grab and element not in ("IMPACT", "NOTE"):
                impacts.append(element)
            grab = element == "IMPACT"
    return impacts


def describe_cwe(tree: Dict[str, Dict], cwe_id: str) -> str:
    """Natural-language description of one CWE node."""
    node = tree[str(cwe_id)]
    text = _with_period(node.get("Name", ""))
    text += _with_period(node.get("Description", ""))
    for impact in _consequence_impacts(node.get("Common Consequences", "")):
        text += _with_period(impact)
    text += _with_period(node.get("Extended Description", ""))
    return text


def cwe_distribution(
    pos_samples: Iterable[Dict], cve_dict: Dict[str, Dict]
) -> Dict[str, Dict]:
    """Count issue reports and CVEs per CWE category over positives
    (reference: utils.py:207-235).  Keys are full ids like ``CWE-79`` or
    the special NVD categories; samples with a missing CWE land in
    ``null``."""
    dist: Dict[str, Dict] = {}
    for sample in pos_samples:
        cve_id = sample["CVE_ID"]
        cwe_id = sample.get("CWE_ID") or cve_dict.get(cve_id, {}).get("CWE_ID") or "null"
        bucket = dist.setdefault(
            cwe_id, {"#issue report": 0, "#CVE": 0, "CVE_distribution": {}}
        )
        bucket["#issue report"] += 1
        if cve_id not in bucket["CVE_distribution"]:
            bucket["CVE_distribution"][cve_id] = 0
            bucket["#CVE"] += 1
        bucket["CVE_distribution"][cve_id] += 1
    return dist


def _category_description(
    tree: Dict[str, Dict],
    bare_id: str,
    member_cves: List[str],
    cve_dict: Dict[str, Dict],
    rng: "random.Random",
    level: int,
    num_cve_per_anchor: int,
) -> str:
    """One anchor's text (reference recipe, utils.py:310-350): in-view
    nodes get the abstraction-ranked BFS subtree description plus up to
    ``num_cve_per_anchor`` sampled member-CVE descriptions; out-of-view
    categories get CVE descriptions alone, 3× as many."""
    description = ""
    if bare_id not in tree:
        k = min(3 * num_cve_per_anchor, len(member_cves))
        for cve_id in rng.sample(member_cves, k=k):
            description += _with_period(
                normalize_text(cve_dict[cve_id]["CVE_Description"])
            )
        return description.strip()
    subtree = bfs_subtree(tree, bare_id, level)
    ranked = sorted(
        subtree,
        key=lambda x: ABSTRACTION_RANK.get(
            tree[x].get("Weakness Abstraction", ""), 4
        ),
    )
    for node_id in ranked:
        description += describe_cwe(tree, node_id)
    k = min(num_cve_per_anchor, len(member_cves))
    for cve_id in rng.sample(member_cves, k=k):
        description += _with_period(
            normalize_text(cve_dict[cve_id]["CVE_Description"])
        )
    return description.strip()


def build_anchors(
    distribution: Dict[str, Dict],
    tree: Dict[str, Dict],
    cve_dict: Dict[str, Dict],
    level: int = 1,
    num_cve_per_anchor: int = 5,
    seed: Optional[int] = None,
) -> Dict[str, str]:
    """Build anchor descriptions for every CWE category in ``distribution``
    (reference: utils.py:310-350).  Returns {category id: description}."""
    rng = random.Random(seed)
    anchors: Dict[str, str] = {}
    for category, info in distribution.items():
        if category == "null":
            continue  # CVE record missing its CWE — dirty data
        member_cves = list(info["CVE_distribution"].keys())
        bare_id = category.split("-", 1)[1] if "-" in category else category
        anchors[category] = _category_description(
            tree, bare_id, member_cves, cve_dict, rng, level, num_cve_per_anchor
        )
    return anchors


def build_full_view_anchors(
    tree: Dict[str, Dict],
    cve_dict: Dict[str, Dict],
    distribution: Optional[Dict[str, Dict]] = None,
    level: int = 1,
    num_cve_per_anchor: int = 5,
    seed: Optional[int] = None,
) -> Dict[str, str]:
    """One anchor per node of the whole Research View (not only the CWEs
    seen in training) plus every train-seen out-of-view category (through
    :func:`build_anchors`'s CVE-description fallback), so a strict
    superset of the train-seen bank's categories.  Nodes with no training
    CVEs get the subtree description alone."""
    rng = random.Random(seed)
    distribution = distribution or {}
    cves_by_category = {
        cat: list(info["CVE_distribution"].keys())
        for cat, info in distribution.items()
        if cat != "null"
    }
    categories = {f"CWE-{bare_id}": bare_id for bare_id in tree}
    for cat in cves_by_category:  # train-seen out-of-view categories
        categories.setdefault(
            cat, cat.split("-", 1)[1] if "-" in cat else cat
        )
    anchors: Dict[str, str] = {}
    for category, bare_id in categories.items():
        description = _category_description(
            tree,
            bare_id,
            cves_by_category.get(category, []),
            cve_dict,
            rng,
            level,
            num_cve_per_anchor,
        )
        if description:
            anchors[category] = description
    return anchors


def save_anchors(anchors: Dict[str, str], path: Union[str, Path]) -> None:
    """Persist an anchor set atomically (tmp + rename)."""
    atomic_write_text(Path(path), json.dumps(anchors, indent=2))


def load_anchors(path: Union[str, Path]) -> Dict[str, str]:
    return json.loads(Path(path).read_text())
