"""The training loop of the single-text classifiers, MemVul-m
(:class:`~memvul_tpu_torch.models.single.SingleModel`) and TextCNN (the
JAX package's ``training/single_trainer.py``).

One cross-entropy step per batch (:func:`classifier_step`), its stats
(loss, pre-clip grad norm, confusion counts) left on the device until a
drain pulls ``sync_every`` of them in one transfer, where the NaN guard
fires.  The reader is read again every epoch, so the negatives are
subsampled again; batches are binned by length (``train_buckets``),
collated and copied to the device on the prefetch thread.  The optimizer
is the grouped AdamW of :func:`~memvul_tpu_torch.training.optim.
make_optimizer` (TextCNN, which has no encoder, trains at ``base_lr``
alone).  After each epoch the validation corpus is scored through
:class:`~memvul_tpu_torch.evaluate.predict_single.SinglePredictor`;
``MetricTracker`` keeps the best epoch (``+pos_f1-score``), patience stops
early, and ``TrainCheckpointer`` saves every epoch and resumes.  Dropout
masks come from the trainer's ``torch.Generator``, whose state is in
every checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.batching import (
    LABELS_BINARY,
    CachedEncoder,
    batches_from_instances,
    bucketed_batches_from_instances,
    prefetch,
    resolve_train_buckets,
)
from ..models.losses import masked_cross_entropy
from .checkpoint import MetricTracker, TrainCheckpointer
from .metrics import RunningClassification, device_confusion, drain_pending
from .optim import GroupedAdamW, make_optimizer
from ..utils.profiling import StepTimer, trace_context
from .trainer import _fetch_stats, host_tree, to_device

logger = logging.getLogger(__name__)


def classifier_step(
    model: torch.nn.Module, optimizer: GroupedAdamW, batch: Dict,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One cross-entropy step over a batch of device tensors; returns the
    step's stats as device tensors: loss, pre-clip grad norm, confusion."""
    optimizer.zero_grad()
    logits = model(batch["sample1"], generator=generator)
    loss = masked_cross_entropy(logits.to(torch.float32), batch["label"], batch["weight"])
    loss.backward()
    with torch.no_grad():
        grad_norm = optimizer.step()
        confusion = device_confusion(logits.detach(), batch["label"], batch["weight"])
    return {"loss": loss.detach(), "grad_norm": grad_norm, "confusion": confusion}


@dataclasses.dataclass
class ClassifierTrainerConfig:
    """Every field of the JAX package's ``ClassifierTrainerConfig``, with
    its defaults (the ``trainer`` section of a single/TextCNN config)."""

    num_epochs: int = 10
    patience: Optional[int] = 10
    validation_metric: str = "+pos_f1-score"
    batch_size: int = 64
    max_length: int = 256
    # "pow2" derives power-of-two buckets up to max_length, a list must
    # cover it, None pads to max_length
    train_buckets: Union[str, Sequence[int], None] = "pow2"
    # batches collated and copied to the device ahead of the step (>= 1)
    prefetch_depth: int = 8
    eval_batch_size: int = 512
    eval_max_length: int = 512
    eval_buckets: Optional[Sequence[int]] = None
    eval_tokens_per_batch: Optional[int] = None
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    base_lr: float = 2e-5
    group_lrs: Optional[Dict[str, float]] = None
    learning_rate_scheduler: Optional[Dict] = None
    momentum_scheduler: Optional[Dict] = None
    grad_clip_norm: Optional[float] = 1.0
    weight_decay: float = 0.0
    seed: int = 2021
    serialization_dir: Optional[str] = None
    keep_checkpoints: int = 1
    steps_per_epoch: Optional[int] = None
    # steps run ahead before a window of stats is pulled to the host; the
    # NaN guard fires there.  1 syncs every step
    sync_every: int = 32
    # the JAX package's checkify mode: not ported (slice 11); a profiler
    # trace of epoch 0 (utils/profiling.trace_context)
    debug_checks: bool = False
    profile_dir: Optional[str] = None


class ClassifierTrainer:
    """Trains ``model`` (a :class:`SingleModel` or :class:`TextCNN`, which
    holds its weights) on ``device`` from ``reader``'s stream over
    ``train_path``, validating on ``validation_path`` after each epoch.
    ``mesh`` is not ported."""

    def __init__(
        self,
        model: torch.nn.Module,
        tokenizer,
        reader,
        train_path: Union[str, Path],
        validation_path: Optional[Union[str, Path]] = None,
        config: Optional[ClassifierTrainerConfig] = None,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ) -> None:
        from ..build import resolve_device

        self.device = resolve_device(device)
        c = self.config = config or ClassifierTrainerConfig()
        if mesh is not None:
            raise NotImplementedError("training on a mesh (DDP) belongs to the multi-device slice")
        if c.debug_checks:
            raise NotImplementedError(
                "debug_checks (checkify) belongs to slice 11, not ported yet; leave it False")
        quant = getattr(getattr(model, "config", None), "quant", None)
        if quant is not None:
            raise ValueError(f"encoder quant={quant!r} is inference-only")
        if int(c.prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {c.prefetch_depth} "
                "(1 = no read-ahead; 0 would deadlock the feed queue)"
            )
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.reader = reader
        self.train_path = str(train_path)
        self.validation_path = str(validation_path) if validation_path else None
        self.encoder = CachedEncoder(tokenizer, max_length=c.max_length)
        self.train_buckets = resolve_train_buckets(c.train_buckets, c.max_length)
        self.optimizer = make_optimizer(
            self.model.named_parameters(),
            group_lrs=c.group_lrs,
            base_lr=c.base_lr,
            warmup_steps=c.warmup_steps,
            total_steps=c.total_steps,
            grad_clip_norm=c.grad_clip_norm,
            weight_decay=c.weight_decay,
            lr_schedule=c.learning_rate_scheduler,
            momentum_schedule=c.momentum_scheduler,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(int(c.seed))
        self.step = 0
        self.epoch = 0
        self.tracker = MetricTracker(c.validation_metric, c.patience)
        self.checkpointer = (
            TrainCheckpointer(c.serialization_dir, c.keep_checkpoints)
            if c.serialization_dir else None
        )
        self.metrics_history: List[Dict[str, Any]] = []

    # -- data ----------------------------------------------------------------

    def _raw_batches(self) -> Iterator[tuple]:
        """(host batch, token counts) over one read of the training file."""
        c = self.config
        instances = self.reader.read(self.train_path, split="train")
        if self.train_buckets is None:
            batches = batches_from_instances(
                instances, self.encoder, batch_size=c.batch_size, label_map=LABELS_BINARY,
            )
        else:
            batches = bucketed_batches_from_instances(
                instances, self.encoder, batch_size=c.batch_size, label_map=LABELS_BINARY,
                buckets=self.train_buckets,
            )
        for batch in batches:
            batch.pop("meta", None)
            yield batch, {
                "padded_tokens": int(batch["sample1"]["input_ids"].size),
                "real_tokens": int(batch["sample1"]["attention_mask"].sum()),
            }

    def _batches(self) -> Iterator[tuple]:
        return prefetch(
            self._raw_batches(), depth=int(self.config.prefetch_depth),
            commit=lambda item: (to_device(item[0], self.device), item[1]),
        )

    # -- epochs --------------------------------------------------------------

    def train_epoch(self) -> Dict[str, Any]:
        c = self.config
        # validation puts the module in eval mode: every epoch starts in
        # training mode again, or dropout is off
        self.model.train()
        running = RunningClassification(2, ["pos", "neg"])
        losses: List[float] = []
        grad_norms: List[float] = []
        pending: List[Dict] = []
        timer = StepTimer()
        padded_tokens = real_tokens = 0
        started = time.perf_counter()
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)

        def drain() -> None:
            drain_pending(pending, _fetch_stats, self.step, losses, running,
                          extras={"grad_norm": grad_norms})

        for i, (batch, info) in enumerate(self._batches()):
            if c.steps_per_epoch is not None and i >= c.steps_per_epoch:
                break
            padded_tokens += info["padded_tokens"]
            real_tokens += info["real_tokens"]
            with timer.step():
                pending.append(classifier_step(self.model, self.optimizer, batch, self.generator))
                self.step += 1
            if len(pending) >= max(1, c.sync_every):
                with timer.distribute_over_last(len(pending)):
                    drain()
        if pending:
            with timer.distribute_over_last(len(pending)):
                drain()
        metrics: Dict[str, Any] = running.compute()
        seconds = time.perf_counter() - started
        metrics.update({
            "loss": float(np.mean(losses)) if losses else 0.0,
            "losses": losses,
            "grad_norms": grad_norms,
            "epoch_seconds": seconds,
            "num_steps": len(losses),
            "padded_tokens": padded_tokens,
            "real_tokens": real_tokens,
            "tokens_per_sec": padded_tokens / max(seconds, 1e-9),
            "real_tokens_per_sec": real_tokens / max(seconds, 1e-9),
            "step_durations_s": list(timer.durations),
        })
        metrics.update(timer.summary())
        if on_card:
            metrics["memory_peak_bytes_in_use"] = float(torch.cuda.max_memory_allocated(self.device))
        return metrics

    def validate(self) -> Dict[str, float]:
        """Score the validation corpus; the metrics come back under the
        reference's ``pos_`` names."""
        if not self.validation_path:
            return {}
        c = self.config
        if not hasattr(self, "_val_predictor"):
            from ..evaluate.predict_single import SinglePredictor

            self._val_predictor = SinglePredictor(
                self.model, self.tokenizer,
                batch_size=c.eval_batch_size,
                max_length=c.eval_max_length,
                buckets=tuple(c.eval_buckets) if c.eval_buckets else None,
                tokens_per_batch=c.eval_tokens_per_batch,
                aot_warmup=False,
            )
        out_dir = (
            Path(c.serialization_dir) if c.serialization_dir
            else Path(tempfile.mkdtemp(prefix="memvul_val_"))
        )
        out = out_dir / f"validation_epoch_{self.epoch}.json"
        measured = self._val_predictor.predict_file(
            self.reader, self.validation_path, out, split="validation"
        )
        rename = {"f1": "pos_f1-score", "prec": "pos_precision", "pd&recall": "pos_recall"}
        return {rename.get(k, k): v for k, v in measured.items()}

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.maybe_restore()
        while self.epoch < c.num_epochs:
            epoch_metrics: Dict[str, Any] = {"epoch": self.epoch}
            # profile_dir: a profiler trace of epoch 0
            with trace_context(c.profile_dir if self.epoch == 0 else None):
                train_metrics = self.train_epoch()
            epoch_metrics.update({f"training_{k}": v for k, v in train_metrics.items()})
            val = self.validate()
            epoch_metrics.update({f"validation_{k}": v for k, v in val.items()})
            self.metrics_history.append(epoch_metrics)
            logger.info("epoch %d: loss %.6f, %s", self.epoch, epoch_metrics["training_loss"],
                        {k: v for k, v in val.items() if isinstance(v, float)})
            is_best = self.tracker.update(val, self.epoch) if val else True
            if self.checkpointer is not None:
                self.checkpointer.save(self.epoch, self._state_dict(), is_best=is_best,
                                       metadata=epoch_metrics)
            self.epoch += 1
            if val and self.tracker.should_stop():
                logger.info("early stopping at epoch %d", self.epoch)
                break
        return {
            "best_epoch": self.tracker.best_epoch,
            "best_validation": self.tracker.best,
            "history": self.metrics_history,
        }

    # -- state ---------------------------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        return {
            "params": host_tree(self.model.state_dict()),
            "opt_state": host_tree(self.optimizer.state_dict()),
            "rng": self.generator.get_state(),
            "meta": {"step": self.step, "epoch": self.epoch, "tracker": self.tracker.state_dict()},
        }

    def maybe_restore(self) -> bool:
        if self.checkpointer is None:
            return False
        restored = self.checkpointer.restore_latest()
        if restored is None:
            return False
        _, state = restored
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.generator.set_state(state["rng"])
        meta = state["meta"]
        self.step = int(meta["step"])
        self.epoch = int(meta["epoch"]) + 1
        self.tracker.load_state_dict(dict(meta["tracker"]))
        logger.info("restored checkpoint at epoch %d", self.epoch - 1)
        return True

    def best_params(self) -> Dict[str, torch.Tensor]:
        """The best-by-validation weights as a host state dict."""
        state = self.checkpointer.restore_best() if self.checkpointer is not None else None
        if state is None:
            return host_tree(self.model.state_dict())
        return state["params"]
