"""Measured roofline report: the program registry's numbers, rendered
(the JAX package's ``tuning/report.py``).

``python -m memvul_tpu_torch tune --report`` renders this module's
markdown from a run dir's ``programs.json`` (or the live registry), and
``--splice`` replaces the section fenced by the marker comments below in
a document.  The rendered text is the JAX package's, word for word, so a
document spliced by either package reads the same.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

BEGIN_MARK = "<!-- BEGIN GENERATED: tune --report -->"
END_MARK = "<!-- END GENERATED: tune --report -->"


def _fmt_count(x: Optional[float], unit: str = "") -> str:
    if x is None:
        return "—"
    x = float(x)
    for factor, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= factor:
            return f"{x / factor:.2f} {suffix}{unit}".rstrip()
    return f"{x:.6g} {unit}".rstrip()


def _fmt_pct(x: Optional[float]) -> str:
    return "—" if x is None else f"{100.0 * float(x):.1f}%"


def roofline_markdown(
    snapshot: Sequence[Dict[str, Any]],
    roofline: Dict[str, Any],
) -> str:
    """The generated roofline section: per-program measured table +
    aggregate achieved-vs-peak summary.  Pure formatting — callable on
    a live registry's ``snapshot()``/``roofline()`` or on a persisted
    ``programs.json``."""
    lines: List[str] = [BEGIN_MARK, ""]
    kind = roofline.get("device_kind", "unknown")
    if roofline.get("interpret_only"):
        lines += [
            f"Measured on `{kind}` — **interpret-only** (no peak spec: "
            "analyzed FLOPs/bytes below are real XLA cost-analysis "
            "output, the busy-util/bandwidth columns stay null rather than "
            "divide by a made-up peak).",
            "",
        ]
    else:
        lines += [
            f"Measured on `{kind}` — peak "
            f"{_fmt_count(roofline.get('peak_flops_per_s'), 'FLOP/s')}, "
            f"{_fmt_count(roofline.get('peak_bytes_per_s'), 'B/s')} HBM.",
            "",
        ]
    lines += [
        "| program | invocations | FLOPs/inv | bytes/inv | HBM bytes "
        "| device s | busy util |",
        "|---|---|---|---|---|---|---|",
    ]
    for row in snapshot:
        lines.append(
            "| `{key}` | {inv} | {flops} | {bytes} | {hbm} | {dev} | {util} |"
            .format(
                key=row.get("key", "?"),
                inv=row.get("invocations", 0),
                flops=_fmt_count(row.get("flops")),
                bytes=_fmt_count(row.get("bytes_accessed")),
                hbm=_fmt_count(row.get("hbm_bytes")),
                dev=f"{row.get('device_time_s', 0.0):.4f}",
                util=_fmt_pct(row.get("busy_util")),
            )
        )
    lines += [
        "",
        "Aggregate: {n} programs, {flops} total FLOPs, {bytes} total "
        "bytes, {dev:.4f} s device time — achieved {af}, {ab}, "
        "busy util {util}, HBM bandwidth {bw}.".format(
            n=roofline.get("programs", len(snapshot)),
            flops=_fmt_count(roofline.get("flops_total")),
            bytes=_fmt_count(roofline.get("bytes_total")),
            dev=float(roofline.get("device_time_s") or 0.0),
            af=_fmt_count(roofline.get("achieved_flops_per_s"), "FLOP/s"),
            ab=_fmt_count(roofline.get("achieved_bytes_per_s"), "B/s"),
            util=_fmt_pct(roofline.get("busy_util")),
            bw=_fmt_pct(roofline.get("membw_util")),
        ),
        "",
        END_MARK,
    ]
    return "\n".join(lines)


def report_from_registry(registry=None) -> str:
    """Render from the live process registry (default: the
    process-wide one)."""
    from ..telemetry.programs import get_program_registry

    reg = registry if registry is not None else get_program_registry()
    return roofline_markdown(reg.snapshot(), reg.roofline())


def report_from_programs_json(path: Union[str, Path]) -> str:
    """Render from a run dir's persisted ``programs.json``
    (``telemetry.programs.write_programs`` output)."""
    payload = json.loads(Path(path).read_text())
    return roofline_markdown(
        payload.get("programs") or [], payload.get("roofline") or {}
    )


def splice_generated_section(doc_text: str, generated: str) -> str:
    """Replace the fenced generated section of a doc with a fresh
    render (or append one when the doc has no fence yet)."""
    begin = doc_text.find(BEGIN_MARK)
    end = doc_text.find(END_MARK)
    if begin == -1 or end == -1 or end < begin:
        sep = "" if doc_text.endswith("\n") else "\n"
        return f"{doc_text}{sep}\n{generated}\n"
    return (
        doc_text[:begin] + generated + doc_text[end + len(END_MARK):]
    )
