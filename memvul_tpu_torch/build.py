"""Config-driven construction and the archive evaluation flow (the JAX
package's ``build.py``, memory model only).

* :func:`encoder_config` — ``{"preset": "base"|"tiny"|"large", "dtype":
  "bfloat16", ...}`` → :class:`BertConfig`;
* :func:`build_model` / :func:`build_tokenizer` / :func:`build_reader`;
* :func:`evaluate_from_archive` — load an archive with overrides, score a
  corpus, write ``{name}_result.json`` and ``{name}_metric_all.json``;
* :func:`serve_from_archive` — load an archive, encode its anchor bank,
  warm the serving shapes and return a running ``ScoringService``
  (single replica).

Everything runs on ``device``, ``"cuda"`` unless the caller asks for the
CPU; on a host without CUDA the default raises instead of falling back.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

logger = logging.getLogger(__name__)

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without CUDA
    raises (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def encoder_config(cfg: Optional[Dict[str, Any]], vocab_size: Optional[int] = None):
    from .models.bert import BertConfig

    cfg = dict(cfg or {})
    preset = cfg.pop("preset", "base")
    dtype = cfg.pop("dtype", None)
    if isinstance(dtype, str):
        cfg["dtype"] = DTYPES[dtype]
    elif dtype is not None:
        cfg["dtype"] = dtype
    if vocab_size is not None:
        cfg.setdefault("vocab_size", vocab_size)
    factory = {"tiny": BertConfig.tiny, "base": BertConfig.base, "large": BertConfig.large}[preset]
    return factory(**cfg)


def build_tokenizer(cfg: Optional[Dict[str, Any]]):
    from .data.tokenizer import WordPieceTokenizer

    cfg = dict(cfg or {})
    kind = cfg.pop("type", "wordpiece")
    if kind != "wordpiece":
        raise NotImplementedError(f"tokenizer type {kind!r} is not ported yet")
    return WordPieceTokenizer(**cfg)


def build_reader(cfg: Optional[Dict[str, Any]]):
    from .data.readers import MemoryReader

    cfg = dict(cfg or {})
    kind = cfg.pop("type", "reader_memory")
    if kind != "reader_memory":
        raise NotImplementedError(f"reader type {kind!r} is not ported yet")
    return MemoryReader(**cfg)


def build_model(model_cfg: Dict[str, Any], vocab_size: int):
    """The memory model named by ``model_cfg`` (params f32, on the CPU)."""
    from .models.memory import MemoryModel

    cfg = dict(model_cfg or {})
    cfg.pop("pretrained_checkpoint", None)
    model_type = cfg.pop("type", "model_memory")
    if model_type != "model_memory":
        raise NotImplementedError(f"model type {model_type!r} is not ported yet")
    return MemoryModel(encoder_config(cfg.pop("encoder", None), vocab_size), **cfg)


def evaluate_from_archive(
    archive_path: Union[str, Path],
    test_path: Union[str, Path],
    out_dir: Union[str, Path],
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    golden_file: Optional[Union[str, Path]] = None,
    name: Optional[str] = None,
    thres: float = 0.5,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Load the archive with overrides, score the test corpus on
    ``device``, write ``{name}_result.json`` + ``{name}_metric_all.json``."""
    from .archive import load_archive
    from .config import evaluation_config
    from .evaluate.predict_memory import test_siamese

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    arch = load_archive(archive_path, overrides=overrides, device=device)
    model_cfg = arch.config.get("model") or {}
    name = name or model_cfg.get("type", "model_memory")
    reader = build_reader(arch.config.get("dataset_reader"))
    eval_cfg = evaluation_config(arch.config)
    max_length = int(eval_cfg["max_length"])
    # overrides written for a longer geometry must not crash a model with
    # a smaller position table deep in the encoder: clamp
    model_positions = arch.model.config.max_position_embeddings
    if max_length > model_positions:
        logger.warning(
            "evaluation max_length %d exceeds the archived model's "
            "max_position_embeddings %d — clamping", max_length, model_positions,
        )
        max_length = model_positions
    buckets = eval_cfg["buckets"]
    if buckets == "auto":
        raise NotImplementedError('evaluation.buckets "auto" is not ported yet')
    if buckets is not None:
        buckets = [int(b) for b in buckets]
    tokens_per_batch = eval_cfg["tokens_per_batch"]
    golden = golden_file or (arch.config.get("dataset_reader") or {}).get("anchor_path")
    if golden is None:
        raise ValueError("memory-model evaluation needs a golden anchor file")
    return test_siamese(
        arch.model,
        arch.tokenizer,
        test_file=test_path,
        golden_file=golden,
        out_results=out_dir / f"{name}_result.json",
        out_metrics=out_dir / f"{name}_metric_all.json",
        reader=reader,
        batch_size=int(eval_cfg["batch_size"]),
        max_length=max_length,
        buckets=buckets,
        tokens_per_batch=None if tokens_per_batch is None else int(tokens_per_batch),
        thres=thres,
        inflight=int(eval_cfg["inflight"]),
        anchor_match_impl=eval_cfg["anchor_match_impl"],
        device=device,
    )


def serve_from_archive(
    archive_path: Union[str, Path],
    out_dir: Optional[Union[str, Path]] = None,
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    golden_file: Optional[Union[str, Path]] = None,
    device: Union[str, torch.device] = "cuda",
):
    """The archive's online scoring service on ``device``: the ``serving``
    section (``config.SERVING_DEFAULTS``) sizes the predictor and the
    admission envelope, the anchor bank is encoded, and every serving
    shape runs once (building the kernel library) before the service is
    returned, so the first request pays no build.  With ``out_dir`` the
    service writes ``telemetry.json`` there when it drains."""
    from .archive import load_archive
    from .config import serving_config
    from .data.batching import validate_buckets
    from .evaluate.predict_memory import SiamesePredictor
    from .resilience.retry import RetryPolicy
    from .serving.service import ScoringService, ServiceConfig

    device = resolve_device(device)
    arch = load_archive(archive_path, overrides=overrides, device=device)
    model_type = (arch.config.get("model") or {}).get("type", "model_memory")
    if model_type != "model_memory":
        raise ValueError(
            f"serving wraps the Siamese memory model; archive has model type {model_type!r}"
        )
    serve_cfg = serving_config(arch.config)
    max_length = int(serve_cfg["max_length"])
    model_positions = arch.model.config.max_position_embeddings
    if max_length > model_positions:
        logger.warning(
            "serving max_length %d exceeds the archived model's "
            "max_position_embeddings %d — clamping", max_length, model_positions,
        )
        max_length = model_positions
    buckets = serve_cfg["buckets"]
    if buckets == "auto":
        raise ValueError(
            'serving.buckets "auto" is an offline policy (it samples a '
            "corpus); pass an explicit bucket list for serving"
        )
    if buckets is not None:
        buckets = validate_buckets([int(b) for b in buckets], max_length)
    score_impl = str(serve_cfg["score_impl"])
    if score_impl not in ("bucketed", "ragged", "continuous", "cascade"):
        raise ValueError(
            "serving.score_impl must be 'bucketed', 'ragged', 'continuous' "
            f"or 'cascade', got {score_impl!r}"
        )
    token_budget = serve_cfg["token_budget"]
    max_rows = serve_cfg["max_rows_per_pack"]
    golden = golden_file or (arch.config.get("dataset_reader") or {}).get("anchor_path")
    if golden is None:
        raise ValueError("serving needs a golden anchor file")
    reader = build_reader(arch.config.get("dataset_reader"))
    retries = int(serve_cfg["retries"])
    predictor = SiamesePredictor(
        arch.model, arch.tokenizer,
        batch_size=int(serve_cfg["max_batch"]),
        max_length=max_length,
        buckets=buckets,
        score_impl=score_impl,
        token_budget=None if token_budget is None else int(token_budget),
        max_rows_per_pack=int(serve_cfg["max_batch"] if max_rows is None else max_rows),
    )
    predictor.encode_anchors(reader.read_anchors(str(golden)))
    shapes = predictor.warmup_compile()
    logger.info("serving warmed %d shape(s) on %s (score_impl=%s)", shapes, device, score_impl)
    return ScoringService(
        predictor,
        config=ServiceConfig(
            max_batch=int(serve_cfg["max_batch"]),
            max_wait_ms=float(serve_cfg["max_wait_ms"]),
            max_queue=int(serve_cfg["max_queue"]),
            default_deadline_ms=float(serve_cfg["default_deadline_ms"]),
            prefix_share=bool(serve_cfg["prefix_share"]),
        ),
        retry_policy=RetryPolicy(attempts=retries) if retries > 0 else None,
        out_dir=out_dir,
    )
