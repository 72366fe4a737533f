"""One-command real-weights F1-parity runner (the JAX package's
``evaluate/parity.py``).

The ±0.5-F1 acceptance (BASELINE.md) needs the genuine bert-base-uncased
checkpoint and a reference-trained ``model.tar.gz`` (reference:
predict_memory.py:62-67).  This module packages the whole chain so that
anyone with those files runs it as one command:

    python -m memvul_tpu_torch parity --hf-dir /path/to/bert-base-uncased \\
        [--archive model.tar.gz --corpus test_project.json \\
         --anchors CWE_anchor_golden_project.json] \\
        [--ref-metrics reference_metric.json] [-o parity_out/] [--device cuda]

Stages (each reported as ``{"skipped": true, "reason": ...}`` when its
inputs are absent):

(a) **convert parity**: HF's torch ``BertModel`` in f32 on the CPU (the
    oracle) against the port's encoder on ``device`` with the same weights
    through :func:`memvul_tpu_torch.models.convert.convert_bert_state_dict`,
    at the checkpoint's own geometry, on random inputs; reports the max
    absolute/relative hidden-state error.  ``transformers`` is imported
    here and nowhere else in the port; where it is missing the stage is
    skipped with ``"ok": false``, so a run without its oracle never reads
    as a pass (the JAX package raises ``ImportError`` instead);
(b) **archive scoring**: load the reference archive
    (:mod:`memvul_tpu_torch.evaluate.reference_archive`), tokenize with the
    checkpoint's own ``vocab.txt`` and run the full streaming evaluation
    (:func:`~memvul_tpu_torch.evaluate.predict_memory.test_siamese`, whose
    bank match is the anchor-match kernel on the card) over ``--corpus``,
    writing the reference-format result and metric files;
(c) **metric diff**: (b)'s metrics against a metric file the reference
    pipeline produced (``--ref-metrics``), failing past the acceptance
    band.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..models.bert import BertConfig, BertEncoder

# max-over-anchors F1 acceptance band, in absolute F1 points (BASELINE.md)
F1_TOLERANCE = 0.005

NO_ORACLE = ("transformers is not installed: stage (a)'s oracle, HF's BertModel, cannot "
             "load, so the conversion was not checked")


def hf_geometry(hf_dir: Union[str, Path]) -> BertConfig:
    """Encoder geometry from an HF checkpoint dir's ``config.json``."""
    cfg = json.loads((Path(hf_dir) / "config.json").read_text())
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
    )


def convert_logit_parity(
    hf_dir: Union[str, Path],
    batch: int = 4,
    seq_len: int = 128,
    seed: int = 0,
    atol: float = 5e-4,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Stage (a): HF's encoder against the port's at checkpoint geometry.

    Loads the torch weights from ``hf_dir`` (``from_pretrained`` on a local
    directory, no network), converts them, and compares the final hidden
    states of the real (unmasked) positions on random inputs, half the
    batch padded.  f32 both sides, so the errors come from op order alone
    and accumulate with depth; ``atol`` is a band 12-layer bert-base clears
    by an order of magnitude."""
    from ..build import resolve_device
    from ..models.convert import convert_bert_state_dict

    device = resolve_device(device)
    try:
        import transformers
    except ImportError:
        return {"skipped": True, "reason": NO_ORACLE, "ok": False}

    config = hf_geometry(hf_dir)
    oracle = transformers.BertModel.from_pretrained(str(hf_dir), local_files_only=True)
    oracle = oracle.float().eval()

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, config.vocab_size, size=(batch, seq_len)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[batch // 2:, seq_len // 2:] = 0  # exercise padding handling too

    with torch.no_grad():
        theirs = oracle(
            input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)
        ).last_hidden_state.numpy()
        encoder_sd, _ = convert_bert_state_dict(oracle.state_dict(), config)
        ours_model = BertEncoder(config)
        ours_model.load_state_dict(encoder_sd)
        ours_model.to(device).eval()
        ours = ours_model(
            torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
        ).float().cpu().numpy()

    real = mask.astype(bool)  # masked positions are junk on both sides
    diff = np.abs(ours[real] - theirs[real])
    denom = np.maximum(np.abs(theirs[real]), 1e-6)
    return {
        "geometry": {
            "hidden_size": config.hidden_size,
            "num_layers": config.num_layers,
            "num_heads": config.num_heads,
            "vocab_size": config.vocab_size,
        },
        "batch": batch,
        "seq_len": seq_len,
        "max_abs_err": float(diff.max()),
        "mean_abs_err": float(diff.mean()),
        "max_rel_err": float((diff / denom).max()),
        "atol": atol,
        "ok": bool(diff.max() <= atol),
    }


def archive_scoring(
    archive: Union[str, Path],
    hf_dir: Union[str, Path],
    corpus: Union[str, Path],
    anchors: Union[str, Path],
    out_dir: Union[str, Path],
    max_length: int = 512,
    batch_size: int = 512,
    thres: float = 0.5,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Stage (b): score ``corpus`` with the reference-trained archive on
    ``device``.

    Geometry comes from the HF checkpoint dir (the archive's config names an
    HF model rather than carrying dims), the vocabulary from its
    ``vocab.txt`` (the genuine file gives reference tokenization exactly).
    The output files follow the reference's result and metric formats."""
    from ..data.readers import MemoryReader
    from ..data.tokenizer import WordPieceTokenizer
    from .predict_memory import test_siamese
    from .reference_archive import load_reference_archive

    vocab = Path(hf_dir) / "vocab.txt"
    if not vocab.exists():
        raise FileNotFoundError(
            f"{vocab} missing: archive scoring needs the checkpoint's own "
            "vocabulary for reference-exact tokenization"
        )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    model, stored = load_reference_archive(archive, hf_geometry(hf_dir), device=device)
    metrics = test_siamese(
        model,
        WordPieceTokenizer(vocab_path=vocab),
        test_file=corpus,
        golden_file=anchors,
        out_results=out / "parity_result.json",
        out_metrics=out / "parity_metric.json",
        reader=MemoryReader(anchor_path=str(anchors)),
        batch_size=batch_size,
        max_length=max_length,
        thres=thres,
        device=device,
    )
    return {
        "archive_config_model": (stored.get("model") or {}).get("type"),
        "result_file": str(out / "parity_result.json"),
        "metric_file": str(out / "parity_metric.json"),
        "metrics": metrics,
    }


def metric_diff(
    ours: Dict[str, float],
    ref_metrics_path: Union[str, Path],
    f1_tolerance: float = F1_TOLERANCE,
) -> Dict[str, Any]:
    """Stage (c): ours against a reference-produced metric file.

    Compares every shared numeric key; the verdict hangs on f1 alone (the
    BASELINE.md criterion)."""
    theirs = json.loads(Path(ref_metrics_path).read_text())
    deltas = {}
    for key, ref_val in theirs.items():
        if isinstance(ref_val, (int, float)) and key in ours:
            deltas[key] = {
                "ours": float(ours[key]),
                "reference": float(ref_val),
                "delta": float(ours[key]) - float(ref_val),
            }
    f1_delta = deltas.get("f1", {}).get("delta")
    return {
        "deltas": deltas,
        "f1_delta": f1_delta,
        "f1_tolerance": f1_tolerance,
        "ok": f1_delta is not None and abs(f1_delta) <= f1_tolerance,
    }


def run_parity(
    hf_dir: Union[str, Path],
    archive: Optional[Union[str, Path]] = None,
    corpus: Optional[Union[str, Path]] = None,
    anchors: Optional[Union[str, Path]] = None,
    ref_metrics: Optional[Union[str, Path]] = None,
    out_dir: Union[str, Path] = "parity_out",
    max_length: int = 512,
    batch_size: int = 512,
    thres: float = 0.5,
    atol: float = 5e-4,
    seq_len: int = 128,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Run every stage whose inputs are present, on ``device``.  A stage
    not run appears as ``{"skipped": true, "reason": ...}``; partially
    supplied scoring inputs are an error, not a skip: an acceptance run that
    quietly dropped its scoring stage must never read as a pass."""
    from ..build import resolve_device

    scoring_inputs = {"--archive": archive, "--corpus": corpus, "--anchors": anchors}
    supplied = [k for k, v in scoring_inputs.items() if v]
    missing = [k for k, v in scoring_inputs.items() if not v]
    if supplied and missing:
        raise ValueError(
            f"archive scoring needs {', '.join(missing)} too (got only {', '.join(supplied)})"
        )
    if ref_metrics and missing:
        raise ValueError(
            "--ref-metrics diffs the archive-scoring metrics: supply "
            "--archive/--corpus/--anchors as well"
        )
    device = resolve_device(device)

    report: Dict[str, Any] = {
        "convert_parity": convert_logit_parity(hf_dir, seq_len=seq_len, atol=atol, device=device)
    }
    ok = report["convert_parity"]["ok"]

    if not missing:
        report["archive_scoring"] = archive_scoring(
            archive, hf_dir, corpus, anchors, out_dir,
            max_length=max_length, batch_size=batch_size, thres=thres, device=device,
        )
        if ref_metrics:
            report["metric_diff"] = metric_diff(report["archive_scoring"]["metrics"], ref_metrics)
            ok = ok and report["metric_diff"]["ok"]
        else:
            report["metric_diff"] = {
                "skipped": True,
                "reason": "pass --ref-metrics <reference metric.json> to diff against the "
                "reference pipeline's own numbers",
            }
    else:
        report["archive_scoring"] = {
            "skipped": True,
            "reason": "pass --archive model.tar.gz --corpus test.json --anchors golden.json "
            "to score a reference-trained checkpoint",
        }
        report["metric_diff"] = {"skipped": True, "reason": "needs archive scoring first"}
    report["ok"] = ok
    return report
