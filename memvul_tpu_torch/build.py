"""Config-driven construction, training and the archive flows (the JAX
package's ``build.py``).

* :func:`encoder_config` — ``{"preset": "base"|"tiny"|"large", "dtype":
  "bfloat16", ...}`` → :class:`BertConfig`;
* :func:`build_model` / :func:`init_params` / :func:`build_tokenizer` /
  :func:`build_reader`: ``model_memory``, ``model_single`` (MemVul-m) and
  ``model_cnn`` (TextCNN); the ``wordpiece`` and ``word`` tokenizers; the
  ``reader_memory`` and ``reader_single`` readers;
* :func:`pretrain_from_config` — MLM further pretraining into
  ``encoder.msgpack`` (:func:`save_encoder_checkpoint`), optionally an HF
  checkpoint (:func:`export_hf_checkpoint`); :func:`load_pretrained_encoder`
  carries it into a model, refusing a layer layout other than the
  target's;
* :func:`train_from_config` — a training run from a reference-shaped
  config into a serialization dir, archiving the best weights as
  ``model.tar.gz`` in the JAX package's format;
* :func:`evaluate_from_archive` — load an archive with overrides, score a
  corpus, write ``{name}_result.json`` and ``{name}_metric_all.json``;
* :func:`serve_from_archive` — load an archive, encode its anchor bank,
  warm the serving shapes and return a running ``ScoringService``, or a
  ``ReplicaRouter`` over several, with the autoscaler and the flight
  recorder when the config asks for them.

Everything runs on ``device``, ``"cuda"`` unless the caller asks for the
CPU; on a host without CUDA the default raises instead of falling back.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
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
    """``type`` "wordpiece" (the default) or "word" (TextCNN's)."""
    from .data.tokenizer import WordPieceTokenizer, WordTokenizer

    cfg = dict(cfg or {})
    kind = cfg.pop("type", "wordpiece")
    tokenizers = {"wordpiece": WordPieceTokenizer, "word": WordTokenizer}
    if kind not in tokenizers:
        raise ValueError(f"unknown tokenizer type {kind!r} (want {sorted(tokenizers)})")
    return tokenizers[kind](**cfg)


def build_reader(cfg: Optional[Dict[str, Any]], seed: Optional[int] = None):
    """The reader (``reader_memory`` by default, or ``reader_single``);
    ``seed`` (the config's ``random_seed``) reaches its sampling RNG unless
    the reader section pins its own."""
    from .data.readers import MemoryReader, SingleReader

    cfg = dict(cfg or {})
    if seed is not None:
        cfg.setdefault("seed", seed)
    kind = cfg.pop("type", "reader_memory")
    readers = {"reader_memory": MemoryReader, "reader_single": SingleReader}
    if kind not in readers:
        raise ValueError(f"unknown reader type {kind!r} (want {sorted(readers)})")
    return readers[kind](**cfg)


def build_model(model_cfg: Dict[str, Any], vocab_size: int):
    """The model named by ``model_cfg["type"]`` (params f32, on the CPU):
    ``model_memory``, ``model_single`` or ``model_cnn``."""
    from .models.memory import MemoryModel
    from .models.single import SingleModel
    from .models.textcnn import TextCNN

    cfg = dict(model_cfg or {})
    cfg.pop("pretrained_checkpoint", None)  # the caller loads it
    model_type = cfg.pop("type", "model_memory")
    if model_type == "model_cnn":
        cfg.pop("encoder", None)
        return TextCNN(vocab_size=vocab_size, **cfg)
    models = {"model_memory": MemoryModel, "model_single": SingleModel}
    if model_type not in models:
        raise ValueError(f"unknown model type {model_type!r}")
    return models[model_type](encoder_config(cfg.pop("encoder", None), vocab_size), **cfg)


def init_params(model, seed: int = 0):
    """Redraw every weight of a CPU ``model`` (as :func:`build_model`
    returns it) from ``seed``, from the distributions the JAX package
    initialises it with.  Returns the model."""
    from .models.bert import init_weights
    from .models.memory import MemoryModel

    gen = torch.Generator().manual_seed(int(seed))
    if isinstance(model, MemoryModel):
        std = model.config.initializer_range
        with torch.no_grad():
            init_weights(model, std, generator=gen)
            model.pair_kernel.normal_(0.0, std, generator=gen)
    else:
        model.init_weights(gen)
    return model


def load_pretrained_encoder(model, checkpoint: Union[str, Path]):
    """Carry a further-pretrained encoder (``encoder.msgpack``, or a
    directory holding one, in the JAX package's flax layout) into
    ``model``'s ``bert``.  The checkpoint's layer layout must be the one
    ``model.config.scan_layers`` names: the JAX package cannot run a
    transplant across layouts, so the port refuses it here.  Returns the
    model."""
    from . import _msgpack
    from .models.convert import STACKED, UNSTACKED, encoder_from_flax, encoder_layout
    from .pretrain.mlm import transplant_encoder

    path = Path(checkpoint)
    if path.is_dir():
        path = path / "encoder.msgpack"
    tree = _msgpack.unpackb(path.read_bytes())
    have = encoder_layout(tree)
    want = STACKED if model.config.scan_layers else UNSTACKED
    if have != want:
        raise ValueError(
            f"pretrained encoder {path} has its layers as {have}, but the model's encoder "
            f"config wants {want}; pretrain with the same encoder.scan_layers as the model "
            "that loads it"
        )
    return transplant_encoder(model, encoder_from_flax(tree, model.config))


def save_encoder_checkpoint(encoder_params: Dict[str, torch.Tensor], config,
                            out_dir: Union[str, Path]) -> Path:
    """Write a pretrained encoder (:func:`~memvul_tpu_torch.pretrain.mlm.
    extract_encoder_params`) as ``<out_dir>/encoder.msgpack``: the flax
    ``bert`` subtree in the layer layout ``config.scan_layers`` names, which
    the JAX package's ``load_pretrained_encoder`` reads."""
    from . import _msgpack
    from .models.convert import flax_encoder

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "encoder.msgpack"
    path.write_bytes(_msgpack.packb(flax_encoder(encoder_params, config)))
    return path


def export_hf_checkpoint(encoder_params: Dict[str, torch.Tensor], config,
                         out_dir: Union[str, Path], tokenizer=None) -> Path:
    """Write an encoder as an HF checkpoint directory (``config.json``,
    ``pytorch_model.bin`` with ``BertModel`` keys, and ``vocab.txt`` when a
    wordpiece tokenizer is given), the layout the reference's embedder
    loads with ``AutoModel.from_pretrained``."""
    import json

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    weights = {k: v.detach().to(torch.float32).cpu().contiguous() for k, v in encoder_params.items()
               if not k.startswith("scalar_mix.")}
    torch.save(weights, out_dir / "pytorch_model.bin")
    (out_dir / "config.json").write_text(json.dumps({
        "model_type": "bert",
        "architectures": ["BertModel"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "max_position_embeddings": config.max_position_embeddings,
        "hidden_act": "gelu",
        "layer_norm_eps": config.layer_norm_eps,
        "hidden_dropout_prob": config.hidden_dropout,
        "attention_probs_dropout_prob": config.attention_dropout,
        "pad_token_id": 0,
        "type_vocab_size": config.type_vocab_size,
    }, indent=2))
    if tokenizer is not None:
        if not hasattr(tokenizer, "save_vocab_txt"):
            raise TypeError(
                f"{type(tokenizer).__name__} cannot export a bert vocab.txt: HF export needs "
                "the wordpiece tokenizer"
            )
        tokenizer.save_vocab_txt(out_dir / "vocab.txt")
    return out_dir


def pretrain_from_config(
    config: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
    export_hf: bool = False,
) -> Dict[str, Any]:
    """MLM further pretraining as a pretrain config (``configs/
    further_pretrain.json``) describes it, on ``device``: the encoder goes
    to ``<output_dir>/encoder.msgpack``, with ``export_hf`` also an HF
    checkpoint under ``<output_dir>/hf``, and a ``validation_data_path``
    adds the held-out ``eval_loss`` and ``perplexity``.  Returns the
    report (``final_loss``, ``checkpoint``[, ``eval_*``, ``perplexity``,
    ``hf_checkpoint``]) and, under ``"train"``, the trainer's result."""
    from .config import telemetry_config, validate_pretrain_config
    from .pretrain.mlm import MLMTrainer, MLMTrainerConfig
    from .telemetry.live import start_run_exposition

    device = resolve_device(device)
    tel_cfg = telemetry_config(config)
    trainer_cfg = validate_pretrain_config(config.get("trainer"))
    tokenizer = build_tokenizer(config.get("tokenizer"))
    bert_cfg = encoder_config(config.get("encoder"), tokenizer.vocab_size)
    trainer = MLMTrainer(bert_cfg, tokenizer, MLMTrainerConfig(**trainer_cfg), device=device)
    out_dir = Path(config.get("output_dir", "further_pretrain/out_wwm"))
    exposition = start_run_exposition(tel_cfg)
    try:
        return _pretrain_run(config, trainer, tokenizer, bert_cfg, out_dir, export_hf)
    finally:
        _end_run(tel_cfg, out_dir, exposition)


def _pretrain_run(config, trainer, tokenizer, bert_cfg, out_dir: Path, export_hf: bool):
    result = trainer.train(config["train_data_path"])
    encoder = trainer.encoder_params()
    report: Dict[str, Any] = {
        "final_loss": result["final_loss"],
        "checkpoint": str(save_encoder_checkpoint(encoder, bert_cfg, out_dir)),
    }
    if config.get("validation_data_path"):
        t0 = time.perf_counter()
        report.update(trainer.evaluate(config["validation_data_path"]))
        result["eval_s"] = time.perf_counter() - t0
    if export_hf:
        report["hf_checkpoint"] = str(
            export_hf_checkpoint(encoder, bert_cfg, out_dir / "hf", tokenizer=tokenizer))
    report["train"] = result
    return report


def _end_run(tel_cfg: Dict[str, Any], run_dir, exposition) -> None:
    """A run's ``finally``: the program table beside its outputs
    (``programs.json``), the exposition port released."""
    from .telemetry.programs import write_programs

    try:
        if tel_cfg["enabled"]:
            write_programs(run_dir)
    finally:
        if exposition is not None:
            exposition.close()


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
    """Train the model a reference-shaped config describes on ``device``
    (``MemoryTrainer`` for ``model_memory``, ``ClassifierTrainer`` for
    ``model_single`` and ``model_cnn``): ``<dir>/config.json``,
    checkpoints, per-epoch metrics, the best weights archived as
    ``<dir>/model.tar.gz`` (readable by the JAX package) and
    ``<dir>/metrics.json``.  An existing ``model.pretrained_checkpoint``
    is loaded into the encoder first (:func:`load_pretrained_encoder`); a
    missing one warns and trains from scratch.  Returns the trainer's
    result with the archive path."""
    import json

    from .archive import ARCHIVE_NAME, save_archive
    from .config import check_training_unported, validate_classifier_config, validate_training_config
    from .models.convert import flax_from_params

    device = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("training on a mesh (DDP) belongs to the multi-device slice")
    check_training_unported(config)
    from .config import telemetry_config
    from .telemetry.live import start_run_exposition

    tel_cfg = telemetry_config(config)
    model_cfg = config.get("model") or {}
    model_type = model_cfg.get("type", "model_memory")
    if model_type not in ("model_memory", "model_single", "model_cnn"):
        raise ValueError(f"unknown model type {model_type!r}")
    if model_type == "model_memory":
        trainer_cfg = validate_training_config(config.get("trainer"))
    else:
        trainer_cfg = validate_classifier_config(config.get("trainer"))
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
            load_pretrained_encoder(model, ckpt)
            logger.info("loaded further-pretrained encoder from %s", ckpt)
        else:
            logger.warning("pretrained_checkpoint %s missing: training from scratch", ckpt)
    trainer_cfg.setdefault("seed", seed)
    trainer_cfg["serialization_dir"] = str(serialization_dir)
    if tel_cfg["trace_dir"] and not trainer_cfg.get("profile_dir"):
        # telemetry.trace_dir: the trainer's epoch-0 profiler trace
        trainer_cfg["profile_dir"] = str(tel_cfg["trace_dir"])
    if model_type == "model_memory":
        from .training.trainer import MemoryTrainer, TrainerConfig

        trainer = MemoryTrainer(
            model, tokenizer, reader,
            train_path=config["train_data_path"],
            validation_path=config.get("validation_data_path"),
            anchor_path=config.get("anchor_path")
            or (config.get("dataset_reader") or {}).get("anchor_path"),
            config=TrainerConfig(**trainer_cfg),
            device=device,
        )
    else:
        from .training.single_trainer import ClassifierTrainer, ClassifierTrainerConfig

        trainer = ClassifierTrainer(
            model, tokenizer, reader,
            train_path=config["train_data_path"],
            validation_path=config.get("validation_data_path"),
            config=ClassifierTrainerConfig(**trainer_cfg),
            device=device,
        )
    exposition = start_run_exposition(tel_cfg)
    try:
        result = trainer.train()
        archived = dict(config)
        archived["model"] = dict(model_cfg)
        save_archive(
            serialization_dir / ARCHIVE_NAME, archived,
            flax_from_params(trainer.best_params(), getattr(model, "config", None)),
            tokenizer_file=_tokenizer_file(config.get("tokenizer")),
        )
        (serialization_dir / "metrics.json").write_text(
            json.dumps(result, indent=2, default=float))
    finally:
        _end_run(tel_cfg, serialization_dir, exposition)
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
    ``buckets: "auto"`` derives ``n_buckets`` boundaries from a
    2048-report sample of the corpus.  A memory model honours every key of
    the ``evaluation`` section (``config.EVALUATION_DEFAULTS``; the
    ``shards*`` keys are ``score-corpus``'s); a single model (MemVul-m, TextCNN)
    goes through ``test_single``, which takes ``batch_size``,
    ``max_length``, ``buckets``, ``n_buckets``, ``tokens_per_batch``,
    ``inflight`` and ``aot_warmup``, and the keys it has no use for raise
    when set away from their defaults (``config.SINGLE_EVALUATION_UNUSED``),
    as do an anchor file and a threshold (it predicts the argmax)."""
    from .archive import load_archive
    from .config import evaluation_config, refuse_single_evaluation_keys

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    arch = load_archive(archive_path, overrides=overrides, device=device)
    model_cfg = arch.config.get("model") or {}
    model_type = model_cfg.get("type", "model_memory")
    name = name or model_type
    reader = build_reader(arch.config.get("dataset_reader"))
    eval_cfg = evaluation_config(arch.config)
    if model_type != "model_memory":
        refuse_single_evaluation_keys(eval_cfg, golden_file=golden_file, thres=thres)
    if int(eval_cfg["shards"]) != 1:
        logger.info("evaluation.shards=%s is read by score-corpus; evaluate scores in one process",
                    eval_cfg["shards"])
    max_length = int(eval_cfg["max_length"])
    # overrides written for a longer geometry must not crash a model with
    # a smaller position table deep in the encoder: clamp (TextCNN has none)
    model_positions = getattr(getattr(arch.model, "config", None), "max_position_embeddings", None)
    if model_positions is not None and max_length > model_positions:
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
    tokens_per_batch = None if tokens_per_batch is None else int(tokens_per_batch)
    out_results = out_dir / f"{name}_result.json"
    out_metrics = out_dir / f"{name}_metric_all.json"
    if model_type != "model_memory":
        from .evaluate.predict_single import test_single

        return test_single(
            arch.model, arch.tokenizer, test_file=test_path, out_results=out_results,
            out_metrics=out_metrics, reader=reader, batch_size=int(eval_cfg["batch_size"]),
            max_length=max_length, buckets=buckets, tokens_per_batch=tokens_per_batch,
            inflight=int(eval_cfg["inflight"]), aot_warmup=bool(eval_cfg["aot_warmup"]),
            device=device,
        )
    from .config import telemetry_config
    from .evaluate.predict_memory import test_siamese

    golden = golden_file or (arch.config.get("dataset_reader") or {}).get("anchor_path")
    if golden is None:
        raise ValueError("memory-model evaluation needs a golden anchor file")
    tel_cfg = telemetry_config(arch.config)
    try:
        return test_siamese(
            arch.model,
            arch.tokenizer,
            test_file=test_path,
            golden_file=golden,
            out_results=out_results,
            out_metrics=out_metrics,
            reader=reader,
            batch_size=int(eval_cfg["batch_size"]),
            max_length=max_length,
            buckets=buckets,
            tokens_per_batch=tokens_per_batch,
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
    finally:
        # the program table beside the results
        _end_run(tel_cfg, out_dir, None)


def _tsdb_cadence(tel_cfg: Dict[str, Any], tsdb_cadence: Optional[float]) -> float:
    """The ``tsdb_cadence`` argument, else ``telemetry.tsdb_cadence_s``."""
    cadence = float(tel_cfg["tsdb_cadence_s"] if tsdb_cadence is None else tsdb_cadence)
    if cadence < 0:
        raise ValueError(f"telemetry.tsdb_cadence_s must be >= 0, got {cadence!r}")
    return cadence


def _attach_flight_recorder(target, serve_cfg: Dict[str, Any], tel_cfg: Dict[str, Any],
                            cadence: float, out_dir):
    """The metrics history, the alert engine and (with ``out_dir``) the
    incident recorder on ``target``, sized by the ``tsdb_*``,
    ``alert_interval_s`` and ``incident_*`` keys; cadence 0 builds nothing."""
    if cadence > 0:
        from .serving.incident import attach_flight_recorder

        attach_flight_recorder(
            target, run_dir=out_dir, registry=getattr(target, "registry", None),
            cadence_s=cadence,
            resolution_s=float(tel_cfg["tsdb_resolution_s"]),
            retention_s=float(tel_cfg["tsdb_retention_s"]),
            alert_interval_s=float(serve_cfg["alert_interval_s"]),
            min_interval_s=float(serve_cfg["incident_min_interval_s"]),
            max_bundles=int(serve_cfg["incident_max_bundles"]),
            window_s=float(serve_cfg["incident_window_s"]),
        )
    return target


def serve_from_hosts(
    hosts: Optional[str] = None,
    out_dir: Optional[Union[str, Path]] = None,
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    tsdb_cadence: Optional[float] = None,
    default_port: int = 8341,
):
    """A :class:`~memvul_tpu_torch.serving.fleet.HostBalancer` over running
    serve processes; no archive is loaded.  ``overrides`` is the whole
    config here: its ``serving.hosts`` is the default of ``hosts`` (then
    ``MEMVUL_FLEET_HOSTS``, see ``fleet.enumerate_hosts``), its ``fleet_*``
    keys configure the balancer's supervision, and ``tsdb_cadence`` (else
    ``telemetry.tsdb_cadence_s``) > 0 attaches the flight recorder as
    :func:`serve_from_archive` does."""
    from .config import loads_config, merge_overrides, serving_config, telemetry_config
    from .serving.fleet import FleetConfig, HostBalancer, ProcessHost, enumerate_hosts

    if isinstance(overrides, str):
        overrides = loads_config(overrides)
    cfg = merge_overrides({}, overrides or {})
    serve_cfg = serving_config(cfg)
    tel_cfg = telemetry_config(cfg)
    spec = hosts or serve_cfg["hosts"]
    if isinstance(spec, (list, tuple)):
        spec = ",".join(str(h) for h in spec)
    urls = enumerate_hosts(spec, default_port=default_port)
    if not urls:
        raise ValueError("no hosts: pass --hosts, serving.hosts or MEMVUL_FLEET_HOSTS")
    cadence = _tsdb_cadence(tel_cfg, tsdb_cadence)
    balancer = HostBalancer([ProcessHost(i, url=u) for i, u in enumerate(urls)],
                            config=FleetConfig.from_serving(serve_cfg))
    return _attach_flight_recorder(balancer, serve_cfg, tel_cfg, cadence, out_dir)


def serve_from_archive(
    archive_path: Union[str, Path],
    out_dir: Optional[Union[str, Path]] = None,
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    golden_file: Optional[Union[str, Path]] = None,
    device: Union[str, torch.device] = "cuda",
    replicas: Optional[int] = None,
    tenants: Optional[str] = None,
    tsdb_cadence: Optional[float] = None,
):
    """The archive's online scoring service on ``device``, or, with
    ``replicas > 1`` (the argument, else ``serving.replicas``) or
    ``serving.autoscale_enabled``, a
    :class:`~memvul_tpu_torch.serving.router.ReplicaRouter` over that many
    services.  The ``serving`` section (``config.SERVING_DEFAULTS``) sizes
    the predictor and the admission envelope; the anchor bank is encoded
    and every serving shape runs once (building the kernel library) before
    a service starts, so the first request pays no build.

    The archive is read once.  Replica ``i`` runs on ``cuda:{i % cards}``
    (every replica on the CPU with ``device="cpu"``); replicas on one card
    share its weight tensors, and each has its own predictor on a CUDA
    stream of its own, anchor bank, warmup and registry.  A replica's
    factory, which its restarts call too, builds a predictor over the
    loaded weights.  With ``out_dir`` a single service writes
    ``telemetry.json`` and the bank manifest there; a fleet configures the
    process-wide registry's sinks there and each replica's in
    ``replica-<i>/``.  ``bankops.baseline`` attaches a drift monitor,
    ``serving.slo_enabled`` an SLO monitor, and ``tenants`` (else
    ``serving.tenants``) installs each named tenant's active bank.

    ``serving.autoscale_enabled`` (which needs ``slo_enabled``) attaches an
    :class:`~memvul_tpu_torch.serving.autoscaler.Autoscaler` that spawns
    replicas through the same factory, up to ``autoscale_max_replicas``;
    the JAX package autoscales only a fleet built with ``replicas > 1``,
    here the router is built for it even from one replica.
    ``tsdb_cadence`` (else ``telemetry.tsdb_cadence_s``) > 0 attaches the
    metrics history and the alert engine, and with ``out_dir`` the
    incident recorder (``serving/incident.py``).  Each replica keeps a
    program registry of its own; a single service records in the
    process-wide one.  ``telemetry.hbm_gauges`` books each service's card
    memory."""
    from . import telemetry
    from .archive import load_archive
    from .bankops.shadow import ShadowConfig
    from .config import bankops_config, serving_config, telemetry_config
    from .data.batching import validate_buckets
    from .evaluate.predict_memory import SiamesePredictor
    from .resilience.retry import RetryPolicy
    from .serving import Replica, ReplicaRouter, RouterConfig, ScoringService, ServiceConfig

    device = resolve_device(device)
    arch = load_archive(archive_path, overrides=overrides, device=device)
    model_type = (arch.config.get("model") or {}).get("type", "model_memory")
    if model_type != "model_memory":
        raise ValueError(
            f"serving wraps the Siamese memory model; archive has model type {model_type!r}"
        )
    serve_cfg = serving_config(arch.config)
    tel_cfg = telemetry_config(arch.config)
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
    trace_sample_rate = float(serve_cfg["trace_sample_rate"])
    if not 0.0 <= trace_sample_rate <= 1.0:
        raise ValueError(f"serving.trace_sample_rate must be in [0, 1], got {trace_sample_rate!r}")
    if serve_cfg["hosts"]:
        raise ValueError("serving.hosts selects the cross-host balancer (serve --hosts), "
                         "which loads no archive")
    tsdb_cadence = _tsdb_cadence(tel_cfg, tsdb_cadence)
    autoscale = bool(serve_cfg["autoscale_enabled"])
    if autoscale and not bool(serve_cfg["slo_enabled"]):
        raise ValueError("serving.autoscale_enabled requires serving.slo_enabled "
                         "(the scale hint comes from the SLO monitor)")
    n_replicas = int(serve_cfg["replicas"] if replicas is None else replicas)
    if n_replicas < 1:
        raise ValueError(f"serving.replicas must be >= 1, got {n_replicas}")
    token_budget = serve_cfg["token_budget"]
    max_rows = serve_cfg["max_rows_per_pack"]
    golden = golden_file or (arch.config.get("dataset_reader") or {}).get("anchor_path")
    if golden is None:
        raise ValueError("serving needs a golden anchor file")
    reader = build_reader(arch.config.get("dataset_reader"))
    anchors = list(reader.read_anchors(str(golden)))
    retries = int(serve_cfg["retries"])
    retry_policy = RetryPolicy(attempts=retries) if retries > 0 else None
    bank_cfg = bankops_config(arch.config)
    service_config = ServiceConfig(
        max_batch=int(serve_cfg["max_batch"]),
        max_wait_ms=float(serve_cfg["max_wait_ms"]),
        max_queue=int(serve_cfg["max_queue"]),
        default_deadline_ms=float(serve_cfg["default_deadline_ms"]),
        prefix_share=bool(serve_cfg["prefix_share"]),
        anchor_stats=bool(bank_cfg["anchor_stats"]),
        trace_sample_rate=trace_sample_rate,
        trace_ring=int(serve_cfg["trace_ring"]),
        cache_capacity=int(serve_cfg["cache_capacity"] or 0),
        hbm_gauges=bool(tel_cfg["hbm_gauges"]),
    )

    def make_predictor(model, stream=None, programs=None):
        predictor = SiamesePredictor(
            model, arch.tokenizer,
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
            stream=stream,
            program_registry=programs,
        )
        predictor.encode_anchors(anchors)
        shapes = predictor.warmup_compile()
        logger.info("serving warmed %d shape(s) on %s (score_impl=%s)", shapes, predictor.device,
                    score_impl)
        return predictor

    def _with_drift_monitor(target):
        # a pinned win-share distribution: republish bank.anchor_drift from
        # the serving counters in the background (stopped at drain)
        if bank_cfg["baseline"]:
            from .bankops.drift import DriftMonitor, load_baseline

            baseline = load_baseline(bank_cfg["baseline"])
            if baseline:
                target.drift_monitor = DriftMonitor(target.registry, baseline,
                                                    interval_s=float(bank_cfg["drift_interval_s"]))
            else:
                logger.warning("bankops.baseline %s is missing or unreadable: no drift gauge",
                               bank_cfg["baseline"])
        return target

    def _with_slo_monitor(target):
        # slo.* gauges, the /healthz slo block and the scale hint (stopped at drain)
        if bool(serve_cfg["slo_enabled"]):
            from .serving.slo import SLOConfig, SLOMonitor

            target.slo_monitor = SLOMonitor(target, registry=target.registry, config=SLOConfig(
                availability_objective=float(serve_cfg["slo_availability_objective"]),
                latency_p95_ms=float(serve_cfg["slo_latency_p95_ms"]),
                fast_window_s=float(serve_cfg["slo_fast_window_s"]),
                window_s=float(serve_cfg["slo_window_s"]),
                interval_s=float(serve_cfg["slo_interval_s"]),
            ))
        return target

    def _with_tenants(target):
        # last, so the installs roll through the assembled target
        target.shadow_config = ShadowConfig.from_bankops(bank_cfg)
        spec = tenants if tenants is not None else serve_cfg["tenants"]
        if spec:
            from .serving.tenancy import configure_tenants

            configure_tenants(target, spec, registry=target.registry)
        return target

    def _with_flight_recorder(target):
        # after the SLO monitor and the autoscaler, which it reads
        return _attach_flight_recorder(target, serve_cfg, tel_cfg, tsdb_cadence, out_dir)

    if n_replicas == 1 and not autoscale:
        service = ScoringService(
            make_predictor(arch.model), config=service_config, retry_policy=retry_policy,
            out_dir=out_dir, manifest_dir=out_dir,
        )
        return _with_tenants(_with_flight_recorder(_with_slo_monitor(_with_drift_monitor(service))))

    # -- the fleet: replica i on cuda:{i % cards}, the weights shared per card
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    models = {next(arch.model.parameters()).device: arch.model}
    models_lock = threading.Lock()

    def device_of(index: int) -> torch.device:
        return torch.device("cuda", index % cards) if device.type == "cuda" else device

    def model_on(dev: torch.device):
        # one copy of the weights per card, made when a replica first lands there
        with models_lock:
            if dev not in models:
                models[dev] = copy.deepcopy(arch.model).to(dev)
                if dev.type == "cuda":
                    # the weights are read from every replica's stream: make them ready first
                    torch.cuda.synchronize(dev)
            return models[dev]

    for i in range(n_replicas):
        model_on(device_of(i))
    if out_dir is not None and bool(tel_cfg["enabled"]):
        telemetry.configure(run_dir=out_dir, events=bool(tel_cfg["events"]),
                            heartbeat_every_s=float(tel_cfg["heartbeat_every_s"]))

    def make_factory(index: int):
        dev = device_of(index)

        def factory(registry):
            stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
            # a replica-private program registry, its events in the
            # replica's registry: /programz rows stay one replica's
            programs = telemetry.ProgramRegistry(telemetry=registry)
            return ScoringService(
                make_predictor(model_on(dev), stream, programs), config=service_config,
                retry_policy=retry_policy, registry=registry,
                manifest_dir=Path(out_dir) / f"replica-{index}" if out_dir is not None else None,
                device=dev,
            )

        return factory

    replica_list = [
        Replica(i, make_factory(i), run_dir=out_dir, device=device_of(i),
                telemetry_enabled=bool(tel_cfg["enabled"]),
                heartbeat_every_s=float(tel_cfg["heartbeat_every_s"]))
        for i in range(n_replicas)
    ]
    logger.info("replica fleet: %d service(s) over %d device(s)", n_replicas, len(models))
    router = ReplicaRouter(
        replica_list,
        config=RouterConfig(
            heartbeat_timeout_s=float(serve_cfg["heartbeat_timeout_s"]),
            max_batch_errors=int(serve_cfg["max_batch_errors"]),
            monitor_interval_s=float(serve_cfg["monitor_interval_s"]),
            max_reroutes=int(serve_cfg["max_reroutes"]),
        ),
        retry_policy=retry_policy,
    )
    router = _with_slo_monitor(_with_drift_monitor(router))
    if autoscale:
        # spawns go through make_factory, the path a restart takes; the
        # controller is stopped at the router's drain
        from .serving.autoscaler import Autoscaler, AutoscalerConfig

        router.autoscaler = Autoscaler(
            router, replica_factory=make_factory, slo_monitor=router.slo_monitor,
            config=AutoscalerConfig.from_serving(serve_cfg),
            registry=router.registry, retry_policy=retry_policy, run_dir=out_dir,
        )
    return _with_tenants(_with_flight_recorder(router))
