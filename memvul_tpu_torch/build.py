"""Config-driven construction, training and the archive flows (the JAX
package's ``build.py``, memory model only).

* :func:`encoder_config` — ``{"preset": "base"|"tiny"|"large", "dtype":
  "bfloat16", ...}`` → :class:`BertConfig`;
* :func:`build_model` / :func:`init_params` / :func:`build_tokenizer` /
  :func:`build_reader`;
* :func:`train_from_config` — a training run from a reference-shaped
  config into a serialization dir, archiving the best weights as
  ``model.tar.gz`` in the JAX package's format;
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


def build_reader(cfg: Optional[Dict[str, Any]], seed: Optional[int] = None):
    """The reader; ``seed`` (the config's ``random_seed``) reaches its
    pair-sampling RNG unless the reader section pins its own."""
    from .data.readers import MemoryReader

    cfg = dict(cfg or {})
    if seed is not None:
        cfg.setdefault("seed", seed)
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
        raise NotImplementedError(
            f"model type {model_type!r} belongs to the other-models slice, not ported yet"
        )
    return MemoryModel(encoder_config(cfg.pop("encoder", None), vocab_size), **cfg)


def init_params(model, seed: int = 0):
    """Redraw every weight of a CPU ``model`` (as :func:`build_model`
    returns it) from ``seed``: N(0, initializer_range) weights, zero
    biases, unit LayerNorm scales.  Returns the model."""
    from .models.bert import init_weights

    gen = torch.Generator().manual_seed(int(seed))
    std = model.config.initializer_range
    with torch.no_grad():
        init_weights(model, std, generator=gen)
        model.pair_kernel.normal_(0.0, std, generator=gen)
    return model


def _tokenizer_file(tok_cfg: Optional[Dict[str, Any]]) -> Optional[str]:
    """The file the archive embeds: the one the tokenizer was built from
    (an existing vocab.txt wins, as in ``WordPieceTokenizer``)."""
    tok_cfg = tok_cfg or {}
    vocab = tok_cfg.get("vocab_path")
    if vocab and Path(vocab).exists():
        return vocab
    return tok_cfg.get("tokenizer_path") or vocab


def train_from_config(
    config: Dict[str, Any],
    serialization_dir: Union[str, Path],
    device: Union[str, torch.device] = "cuda",
    mesh=None,
) -> Dict[str, Any]:
    """Train the memory model a reference-shaped config describes on
    ``device``: ``<dir>/config.json``, checkpoints, per-epoch metrics, the
    best weights archived as ``<dir>/model.tar.gz`` (readable by the JAX
    package) and ``<dir>/metrics.json``.  Returns the trainer's result
    with the archive path."""
    import json

    from .archive import ARCHIVE_NAME, save_archive
    from .config import check_training_unported, validate_training_config
    from .models.convert import flax_from_params
    from .training.trainer import MemoryTrainer, TrainerConfig

    device = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("training on a mesh (DDP) belongs to the multi-device slice")
    check_training_unported(config)
    model_cfg = config.get("model") or {}
    if model_cfg.get("type", "model_memory") != "model_memory":
        raise NotImplementedError(
            f"model type {model_cfg.get('type')!r}: the single/TextCNN trainers belong to "
            "the other-models slice, not ported yet"
        )
    trainer_cfg = validate_training_config(config.get("trainer"))
    serialization_dir = Path(serialization_dir)
    serialization_dir.mkdir(parents=True, exist_ok=True)
    (serialization_dir / "config.json").write_text(json.dumps(config, indent=2))

    seed = int(config.get("random_seed", 2021))
    tokenizer = build_tokenizer(config.get("tokenizer"))
    reader = build_reader(config.get("dataset_reader"), seed=seed)
    model = init_params(build_model(model_cfg, tokenizer.vocab_size), seed)
    ckpt = model_cfg.get("pretrained_checkpoint")
    if ckpt:
        if Path(ckpt).exists():
            raise NotImplementedError(
                f"pretrained_checkpoint {ckpt}: loading a further-pretrained encoder "
                "belongs to the MLM slice, not ported yet"
            )
        logger.warning("pretrained_checkpoint %s missing: training from scratch", ckpt)
    trainer_cfg.setdefault("seed", seed)
    trainer_cfg["serialization_dir"] = str(serialization_dir)
    trainer = MemoryTrainer(
        model, tokenizer, reader,
        train_path=config["train_data_path"],
        validation_path=config.get("validation_data_path"),
        anchor_path=config.get("anchor_path")
        or (config.get("dataset_reader") or {}).get("anchor_path"),
        config=TrainerConfig(**trainer_cfg),
        device=device,
    )
    result = trainer.train()
    archived = dict(config)
    archived["model"] = dict(model_cfg)
    save_archive(
        serialization_dir / ARCHIVE_NAME, archived,
        flax_from_params(trainer.best_params(), model.config),
        tokenizer_file=_tokenizer_file(config.get("tokenizer")),
    )
    (serialization_dir / "metrics.json").write_text(json.dumps(result, indent=2, default=float))
    result["archive"] = str(serialization_dir / ARCHIVE_NAME)
    return result


def _auto_buckets_for_corpus(
    reader, tokenizer, test_path, max_length: int, n_buckets: int = 8, sample: int = 2048,
):
    """The token lengths of the corpus head (``sample`` reports) → the
    padding-minimising bucket boundaries (``data.batching.auto_buckets``)."""
    import itertools

    from .data.batching import auto_buckets

    texts = [inst["text1"] for inst in itertools.islice(reader.read(str(test_path), split="test"), sample)]
    lengths = [len(ids) for ids in tokenizer.encode_many(texts, max_length=max_length)]
    return auto_buckets(lengths, max_length, n_buckets=n_buckets)


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
    ``device``, write ``{name}_result.json`` + ``{name}_metric_all.json``.
    Every key of the ``evaluation`` section is honoured
    (``config.EVALUATION_DEFAULTS``) or raises
    (``config.EVALUATION_UNPORTED``); ``buckets: "auto"`` derives
    ``n_buckets`` boundaries from a 2048-report sample of the corpus."""
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
        buckets = _auto_buckets_for_corpus(
            reader, arch.tokenizer, test_path, max_length, n_buckets=int(eval_cfg["n_buckets"]),
        )
        logger.info("auto buckets for %s: %s", test_path, buckets)
    elif buckets is not None:
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
        aot_warmup=bool(eval_cfg["aot_warmup"]),
        resume=bool(eval_cfg["resume"]),
        quarantine=eval_cfg["quarantine"],
        heartbeat_batches=int(eval_cfg["heartbeat_batches"]),
        score_retries=int(eval_cfg["score_retries"]),
        attribute_anchors=bool(eval_cfg["attribute_anchors"]),
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
        # the cascade's first tier is the int8 twin
        encoder_precision="int8" if score_impl == "cascade" else "fp32",
        cascade_low=float(serve_cfg["cascade_low"]),
        cascade_high=float(serve_cfg["cascade_high"]),
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
