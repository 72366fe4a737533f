"""Config-driven construction and the archive evaluation flow (the JAX
package's ``build.py``, memory model only).

* :func:`encoder_config` — ``{"preset": "base"|"tiny"|"large", "dtype":
  "bfloat16", ...}`` → :class:`BertConfig`;
* :func:`build_model` / :func:`build_tokenizer` / :func:`build_reader`;
* :func:`evaluate_from_archive` — load an archive with overrides, score a
  corpus, write ``{name}_result.json`` and ``{name}_metric_all.json``.

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
