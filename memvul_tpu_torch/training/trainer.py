"""The training loop for the Siamese memory model (the JAX package's
``training/trainer.py``).

The semantics kept from the reference trainer:

* **online sampling**: the pair stream is re-rolled every epoch, from a
  per-epoch seed (:meth:`MemoryTrainer._epoch_seed`), so each epoch's
  stream is a pure function of (seed, epoch) and a resumed run replays it;
  ``online_resample=False`` freezes epoch 0's stream instead;
* **anchor re-encode before validation**: after each train epoch the
  anchor bank is re-encoded with the current (or EMA) weights, then the
  validation corpus is matched against it;
* gradient accumulation over a stack of K microbatches, grad-norm
  clipping, the warmup schedule, the NaN guard, patience-based early
  stopping on ``+s_f1-score``, best-model selection, checkpoint and
  resume, SIGTERM/SIGINT preemption with a mid-epoch resume;
* the run sinks: the process-wide telemetry registry gets the
  ``train_epoch``, ``validate`` and ``checkpoint`` spans, a ``train_step``
  event per step (``step``, ``loss``, ``lr``, ``grad_norm``) as each window
  of stats drains, a ``train_epoch`` event and the ``train.*`` counters;
* the chaos point ``step.<global step>`` at the start of each step
  (``step.N=sigterm`` preempts through the signal handler) and
  ``debug_checks`` (:func:`~.metrics.check_finite` before each update).

One optimizer step (:func:`train_step`) runs the K microbatches' forward
and backward, accumulating gradients, divides them by K (dead
zero-weight microbatches included, as the JAX step's mean over the stack
does), clips, updates and, with ``ema_decay``, moves the EMA weights.
Its stats (loss, pre-clip grad norm, confusion counts) stay on the device
until a drain pulls a window of them in one call (:data:`_host_fetch`).
Dropout masks come from the trainer's ``torch.Generator`` on the model's
device, seeded from ``TrainerConfig.seed``; its state is in every
checkpoint.  Stacks are collated and copied to the device (pinned host
memory, ``non_blocking``) on the prefetch thread.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import signal
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.batching import (
    LABELS_SIAMESE,
    CachedEncoder,
    batches_from_instances,
    bucketed_pair_batches_from_instances,
    prefetch,
    resolve_train_buckets,
)
from ..data.readers import MemoryReader
from ..models.memory import MemoryModel, pair_loss
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, all_reduce_data, any_rank, replicate, shard_batch
from ..resilience import faults
from ..resilience.io import atomic_write_text
from ..telemetry import get_registry
from ..utils.profiling import StepTimer, trace_context
from .checkpoint import MetricTracker, TrainCheckpointer
from .metrics import RunningClassification, check_finite, device_confusion, drain_pending
from .optim import GroupedAdamW, make_optimizer

logger = logging.getLogger(__name__)


def _fetch_stats(pending: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """A window of per-step stats dicts → host numpy, one copy per key."""
    keys = list(pending[0])
    stacked = {k: torch.stack([p[k] for p in pending]).cpu().numpy() for k in keys}
    return [{k: stacked[k][i] for k in keys} for i in range(len(pending))]


# every blocking device→host pull of the epoch loop goes through this
# alias, so tests can count the transfers (the loop runs ahead of the
# device instead of syncing each step)
_host_fetch = _fetch_stats


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def to_device(tree, device: torch.device):
    """Nested dicts of host arrays → the same tree of tensors on ``device``
    (int32 ids widened to int64); on the card through pinned host memory,
    ``non_blocking``, so a prefetch thread's copy overlaps the step."""
    on_card = device.type == "cuda"

    def put(x):
        t = torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)
        if on_card:
            t = t.pin_memory()
        return t.to(device, non_blocking=on_card)

    return _tree_map(put, tree)


def host_tree(tree):
    """Nested dicts and lists with the tensors detached onto the host."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def train_step(
    model: MemoryModel,
    optimizer: GroupedAdamW,
    stack: Dict,
    generator: Optional[torch.Generator] = None,
    ema_model: Optional[MemoryModel] = None,
    ema_decay: Optional[float] = None,
    debug_checks: bool = False,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """One optimizer step over a [K, B, ...] stack of device tensors:
    forward and backward per microbatch (gradients summed, then divided by
    K), the pre-clip global norm, the clipped AdamW update and, with
    ``ema_model``, ``ema = ema·decay + params·(1 − decay)``.  With
    ``debug_checks`` the parameters, loss and gradients are checked finite
    before the update (:func:`~.metrics.check_finite`).  Returns the
    step's stats as device tensors: mean loss, grad norm, confusion.

    On a ``mesh`` with a data axis, ``stack`` holds this rank's rows: each
    microbatch's loss divides by the global weight sum (one all-reduce of
    the K sums up front), so summing the ranks' gradients and losses (one
    all-reduce a step, after the K backwards) gives the single-device
    step's exactly, however the padding rows fall.  A ``model`` axis holds
    copies (the JAX trainers replicate the params over it): the copies of
    a data slice take the same rows, and the sum reaches every rank with
    the same bits (:func:`~memvul_tpu_torch.parallel.mesh.all_reduce_data`),
    so the copies stay equal step after step.  A tensor-parallel model
    (:func:`~memvul_tpu_torch.parallel.sharding.shard_params`) sums its
    shards' gradients over ``data`` alone."""
    k = stack["label"].shape[0]
    group = mesh[DATA_AXIS] if mesh is not None and mesh.size(DATA_AXIS) > 1 else None
    optimizer.zero_grad()
    loss_sum = torch.zeros((), dtype=torch.float32, device=stack["label"].device)
    totals = [None] * k
    if group is not None:
        totals = stack["weight"].to(torch.float32).sum(dim=1)
        torch.distributed.all_reduce(totals, group=group)
    logits = []
    for i in range(k):
        mb = _tree_map(lambda x: x[i], stack)
        out = model(mb["sample1"], mb["sample2"], sample2_index=mb.get("sample2_index"),
                    generator=generator)
        loss = pair_loss(out, mb["label"], mb["weight"], model.temperature, totals[i])
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        logits.append(out.detach())
    with torch.no_grad():
        confusion = device_confusion(torch.stack(logits), stack["label"], stack["weight"])
        # a tensor-parallel model's model ranks hold shards, not copies
        all_reduce_data([p.grad for p in optimizer.params] + [loss_sum, confusion], mesh,
                        model_copies=not hasattr(model, "tp_specs"))
        for p in optimizer.params:
            p.grad.div_(k)
        if debug_checks:
            check_finite(loss_sum / k, model.named_parameters())
        grad_norm = optimizer.step()
        if ema_model is not None:
            decay = float(ema_decay)
            for e, p in zip(ema_model.parameters(), model.parameters()):
                e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)
    return {"loss": loss_sum / k, "grad_norm": grad_norm, "confusion": confusion}


def _training_mesh(mesh):
    """The mesh a trainer takes: the data and model axes, each of any
    size.  As in the JAX trainers, the params and the optimizer state are
    replicated over the whole mesh and each batch is sharded over ``data``
    alone, so a model rank trains a copy."""
    if mesh is None:
        return None
    extra = set(mesh.axis_names) - {DATA_AXIS, MODEL_AXIS}
    if extra:
        raise ValueError(f"a training mesh takes the data and model axes, got {sorted(extra)}")
    return mesh


def _seed_rank_generator(generator: torch.Generator, seed: int, mesh,
                         restored_step: Optional[int] = None) -> None:
    """Data rank 0 keeps the single-device dropout stream (a restored one
    its checkpointed state); every other data rank draws its own, from
    (seed, rank, step), so no two slices share masks."""
    index = mesh.index(DATA_AXIS) if mesh is not None else 0
    if index == 0:
        if restored_step is None:
            generator.manual_seed(seed)
        return
    step = restored_step or 0
    generator.manual_seed((seed * 1_000_003 + index * 7919 + step) & 0x7FFFFFFF)


def _shard_stack(stack: Dict, mesh) -> Dict:
    """This rank's rows of a [K, B, ...] stack; with the dedup gather
    (``sample2_index``) the unique ``sample2`` rows stay whole, since any
    rank's pairs may point at any of them."""
    whole = {"sample2": stack["sample2"]} if "sample2_index" in stack else {}
    sharded = shard_batch({k: v for k, v in stack.items() if k not in whole}, mesh, batch_axis=1)
    return {**sharded, **whole}


def book_epoch(tel, epoch: int, metrics: Dict[str, Any], durations: Sequence[float]) -> None:
    """An epoch's telemetry, as the JAX trainers book it: the step times in
    ``train.step_s``, the token counters and rates, and a ``train_epoch``
    event with the epoch's scalar metrics."""
    step_hist = tel.histogram("train.step_s")
    for d in durations:
        step_hist.observe(d)
    tel.counter("train.tokens").inc(metrics["padded_tokens"])
    tel.counter("train.tokens_real").inc(metrics["real_tokens"])
    tel.gauge("train.tokens_per_sec").set(metrics["tokens_per_sec"])
    tel.gauge("train.real_tokens_per_sec").set(metrics["real_tokens_per_sec"])
    tel.event("train_epoch", epoch=epoch,
              **{k: v for k, v in metrics.items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)})


@dataclasses.dataclass
class TrainerConfig:
    """Every field of the JAX package's ``TrainerConfig``, with its
    defaults (the ``trainer`` section of a config)."""

    num_epochs: int = 30
    patience: Optional[int] = 10
    validation_metric: str = "+s_f1-score"
    batch_size: int = 32
    grad_accum: int = 2
    max_length: int = 256
    # length-binned train collation: "pow2" derives power-of-two buckets
    # up to max_length, a list must cover it, None pads to max_length
    train_buckets: Union[str, Sequence[int], None] = "pow2"
    # encode only each batch's unique sample2 rows and gather them back
    # (bucketed collation only)
    dedup_anchors: bool = True
    # stacks collated and copied to the device ahead of the step (>= 1)
    prefetch_depth: int = 8
    eval_batch_size: int = 512
    eval_max_length: int = 512
    eval_buckets: Optional[Sequence[int]] = None
    eval_tokens_per_batch: Optional[int] = None
    warmup_steps: int = 10000
    total_steps: Optional[int] = None  # enables linear decay after warmup
    base_lr: float = 1e-4
    group_lrs: Optional[Dict[str, float]] = None
    learning_rate_scheduler: Optional[Dict] = None
    momentum_scheduler: Optional[Dict] = None
    grad_clip_norm: Optional[float] = 1.0
    weight_decay: float = 0.0
    seed: int = 2021
    serialization_dir: Optional[str] = None
    # 2: a corrupt newest checkpoint falls back to the one before
    keep_checkpoints: int = 2
    # a mid-epoch step checkpoint every N optimizer steps (None: only on
    # preemption)
    save_every_steps: Optional[int] = None
    # {"step", "loss"} JSON lines appended here as the stats drain
    step_loss_log: Optional[str] = None
    steps_per_epoch: Optional[int] = None
    # False freezes epoch 0's pair sample for every epoch
    online_resample: bool = True
    # a profiler trace of epoch 0 (utils/profiling.trace_context)
    profile_dir: Optional[str] = None
    # the JAX package's checkify float checks: every step checks its
    # parameters, loss and gradients finite before the update (one host
    # sync a step) and raises FloatingPointError naming the first that is not
    debug_checks: bool = False
    ema_decay: Optional[float] = None
    # steps run ahead before a window of stats is pulled to the host; the
    # NaN guard fires there.  1 syncs every step
    sync_every: int = 32


class MemoryTrainer:
    """Trains ``model`` (which holds the weights; the JAX trainer takes
    them apart) on ``device`` from ``reader``'s pair stream over
    ``train_path``, validating against ``anchor_path``'s bank on
    ``validation_path`` after each epoch.

    On a ``mesh`` (:func:`~memvul_tpu_torch.parallel.create_mesh`, the
    data and model axes) every rank reads the same stream and trains on its
    data slice of each stack's rows (the dedup's unique ``sample2`` rows
    stay whole on every rank; the dedup floor is the data size); the
    update equals the single-device step's on the global batch
    (:func:`train_step`).  The params and the optimizer state are
    replicated over the whole mesh, as in the JAX trainer: the ranks of a
    ``model`` axis train equal copies.  Rank 0 alone writes checkpoints,
    the preemption marker, the step-loss log and the validation output;
    every rank restores.  A stop signal is agreed at each stats drain, so
    the ranks stop at the same step."""

    def __init__(
        self,
        model: MemoryModel,
        tokenizer,
        reader: MemoryReader,
        train_path: Union[str, Path],
        validation_path: Optional[Union[str, Path]] = None,
        anchor_path: Optional[Union[str, Path]] = None,
        config: Optional[TrainerConfig] = None,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ) -> None:
        from ..build import resolve_device

        # a mesh's rank owns its device
        self.device = mesh.device if mesh is not None else resolve_device(device)
        c = self.config = config or TrainerConfig()
        self.mesh = _training_mesh(mesh)
        self._writes = mesh is None or mesh.is_primary
        if model.config.quant is not None:
            raise ValueError(f"encoder quant={model.config.quant!r} is inference-only")
        if int(c.prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {c.prefetch_depth} "
                "(1 = no read-ahead; 0 would deadlock the feed queue)"
            )
        self.model = model.to(self.device)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.tokenizer = tokenizer
        self.reader = reader
        self.train_path = str(train_path)
        self.validation_path = str(validation_path) if validation_path else None
        self.anchor_path = str(anchor_path) if anchor_path else None
        self.encoder = CachedEncoder(tokenizer, max_length=c.max_length)
        self.train_buckets = resolve_train_buckets(c.train_buckets, c.max_length)
        # under a data mesh every device-fed dimension divides the axis
        self._dedup_cap_floor = max(8, self.mesh.size(DATA_AXIS) if self.mesh else 1)
        total_steps = c.total_steps
        if total_steps is None and c.steps_per_epoch is not None:
            total_steps = c.num_epochs * c.steps_per_epoch
        self.total_steps = total_steps
        self.optimizer = make_optimizer(
            self.model.named_parameters(),
            group_lrs=c.group_lrs,
            base_lr=c.base_lr,
            warmup_steps=c.warmup_steps,
            total_steps=total_steps,
            grad_clip_norm=c.grad_clip_norm,
            weight_decay=c.weight_decay,
            lr_schedule=c.learning_rate_scheduler,
            momentum_schedule=c.momentum_scheduler,
        )
        self.generator = torch.Generator(device=self.device)
        _seed_rank_generator(self.generator, int(c.seed), self.mesh)
        self.step = 0
        self.epoch = 0
        self._stop_signal: Optional[int] = None
        self._resume_skip_stacks = 0
        self._epoch_stacks_done = 0
        self.tracker = MetricTracker(c.validation_metric, c.patience)
        self.checkpointer = (
            TrainCheckpointer(c.serialization_dir, c.keep_checkpoints)
            if c.serialization_dir else None
        )
        self.metrics_history: List[Dict[str, Any]] = []
        # the EMA weights live in a module of their own, which validation
        # scores with; the live model is never swapped
        self.ema_model: Optional[MemoryModel] = None
        if c.ema_decay is not None:
            self.ema_model = copy.deepcopy(self.model).requires_grad_(False)

    # -- data ----------------------------------------------------------------

    def _epoch_seed(self, epoch: int) -> int:
        """The epoch's pair-sampling seed, a pure function of (seed,
        epoch): a mid-epoch resume replays the interrupted epoch."""
        return (self.config.seed * 1_000_003 + epoch) & 0x7FFFFFFF

    def _reseed_reader(self, epoch: int) -> None:
        reseed = getattr(self.reader, "reseed", None)
        if reseed is not None:
            reseed(self._epoch_seed(epoch))

    def _train_instances(self):
        """The epoch's pair stream; with ``online_resample`` off, epoch 0's
        stream frozen and replayed."""
        if self.config.online_resample:
            self._reseed_reader(self.epoch)
            return self.reader.read(self.train_path, split="train")
        if not hasattr(self, "_frozen_instances"):
            self._reseed_reader(0)
            self._frozen_instances = list(self.reader.read(self.train_path, split="train"))
        return iter(self._frozen_instances)

    def _microbatch_stacks(self) -> Iterator[tuple]:
        """The epoch's pair stream grouped into [K, B, L] stacks of host
        arrays: each batch shape accumulates its own group, and epoch-end
        tails are padded with zero-weight copies.  Emission order is a pure
        function of the stream.  Yields ``(stack, info)`` with the stack's
        padded and real token counts."""
        c = self.config
        if self.train_buckets is None:
            batches = batches_from_instances(
                self._train_instances(), self.encoder, batch_size=c.batch_size,
                label_map=LABELS_SIAMESE,
            )
        else:
            batches = bucketed_pair_batches_from_instances(
                self._train_instances(), self.encoder, batch_size=c.batch_size,
                label_map=LABELS_SIAMESE, buckets=self.train_buckets,
                dedup_side2=c.dedup_anchors, dedup_cap_floor=self._dedup_cap_floor,
            )
        groups: Dict[tuple, List[Dict]] = {}
        for batch in batches:
            batch.pop("meta", None)
            key = (batch["sample1"]["input_ids"].shape, batch["sample2"]["input_ids"].shape)
            group = groups.setdefault(key, [])
            group.append(batch)
            if len(group) == c.grad_accum:
                yield self._stack(group)
                groups[key] = []
        for group in groups.values():
            if not group:
                continue
            while len(group) < c.grad_accum:
                dead = _tree_map(np.copy, group[-1])
                dead["weight"] = np.zeros_like(dead["weight"])
                group.append(dead)
            yield self._stack(group)

    @staticmethod
    def _stack(group: List[Dict]) -> tuple:
        padded = real = 0
        for b in group:
            for side in ("sample1", "sample2"):
                padded += int(b[side]["input_ids"].size)
                real += int(b[side]["attention_mask"].sum())
        stacked = _tree_map(lambda *xs: np.stack(xs, axis=0), *group)
        return stacked, {"padded_tokens": padded, "real_tokens": real}

    def _commit_stack(self, item: tuple) -> tuple:
        """The host-to-device copy, on the prefetch worker so stack N+1's
        copy overlaps step N: pinned host memory, ``non_blocking``."""
        stack, info = item
        if self.mesh is not None:
            stack = _shard_stack(stack, self.mesh)
        return to_device(stack, self.device), info

    # -- epoch orchestration ---------------------------------------------------

    def _lr_at(self, step: int) -> float:
        """The default group's learning rate at ``step`` (the schedule's
        scale times ``base_lr``), for the ``train_step`` events."""
        return self.optimizer.scale(step) * self.config.base_lr

    def _drain_stats(self, pending, running, losses, grad_norms=None) -> None:
        """One host transfer per window; the NaN guard fires here.  The
        ``train_step`` events ride the drained window, so a registry
        without ``step_events`` costs the step loop nothing."""
        n_before = len(losses)
        drain_pending(
            pending, _host_fetch, self.step, losses, running,
            extras={"grad_norm": grad_norms} if grad_norms is not None else None,
        )
        new = losses[n_before:]
        if not new:
            return
        first = self.step - len(new)
        if self.config.step_loss_log and self._writes:
            with open(self.config.step_loss_log, "a") as f:
                for offset, loss in enumerate(new):
                    f.write(json.dumps({"step": first + offset, "loss": loss}) + "\n")
        tel = get_registry()
        tel.counter("train.steps").inc(len(new))
        if tel.step_events:
            new_norms = grad_norms[n_before:] if grad_norms is not None else []
            for offset, loss in enumerate(new):
                fields = {"step": first + offset, "loss": round(loss, 6),
                          "lr": self._lr_at(first + offset)}
                if offset < len(new_norms):
                    fields["grad_norm"] = round(new_norms[offset], 6)
                tel.event("train_step", **fields)
        tel.heartbeat()

    def train_epoch(self) -> Dict[str, float]:
        c = self.config
        tel = get_registry()
        # the validation predictor puts the shared module in eval mode:
        # every epoch starts in training mode again, or dropout is off
        self.model.train()
        running = RunningClassification(2, ["same", "diff"])
        losses: List[float] = []
        grad_norms: List[float] = []
        pending: List[Dict] = []
        timer = StepTimer()
        padded_tokens = real_tokens = 0
        started = time.perf_counter()
        skip = self._resume_skip_stacks
        self._resume_skip_stacks = 0
        self._epoch_stacks_done = skip
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        feed = prefetch(
            self._microbatch_stacks(), depth=int(c.prefetch_depth), commit=self._commit_stack,
            occupancy=tel.gauge("train.feed_occupancy"),
        )
        with tel.span("train_epoch", epoch=self.epoch):
            for i, (stack, info) in enumerate(feed):
                if c.steps_per_epoch is not None and i >= c.steps_per_epoch:
                    break
                if i < skip:
                    continue
                padded_tokens += info["padded_tokens"]
                real_tokens += info["real_tokens"]
                # chaos: "step.<global step>" fires as the step starts
                faults.fault_point(f"step.{self.step}")
                with timer.step():
                    pending.append(train_step(
                        self.model, self.optimizer, stack, self.generator,
                        self.ema_model, c.ema_decay, c.debug_checks, self.mesh,
                    ))
                    self.step += 1
                self._epoch_stacks_done = i + 1
                synced = False
                if len(pending) >= max(1, c.sync_every):
                    with timer.distribute_over_last(len(pending)):
                        self._drain_stats(pending, running, losses, grad_norms)
                    synced = True
                if c.save_every_steps and self.checkpointer is not None \
                        and self.step % c.save_every_steps == 0:
                    with timer.distribute_over_last(max(1, len(pending))):
                        self._drain_stats(pending, running, losses, grad_norms)
                    self._save_step_checkpoint()
                    synced = True
                if self._should_stop(synced):
                    logger.warning(
                        "stop signal %s: halting after step %d (%d/%s stacks of epoch %d)",
                        self._stop_signal, self.step - 1, self._epoch_stacks_done,
                        c.steps_per_epoch or "?", self.epoch,
                    )
                    break
            if pending:
                with timer.distribute_over_last(len(pending)):
                    self._drain_stats(pending, running, losses, grad_norms)
        metrics: Dict[str, Any] = running.compute()
        metrics["loss"] = float(np.mean(losses)) if losses else 0.0
        metrics["losses"] = losses
        metrics["grad_norms"] = grad_norms
        metrics["epoch_seconds"] = time.perf_counter() - started
        metrics["num_steps"] = len(losses)
        metrics["padded_tokens"] = padded_tokens
        metrics["real_tokens"] = real_tokens
        metrics["tokens_per_sec"] = padded_tokens / max(metrics["epoch_seconds"], 1e-9)
        metrics["real_tokens_per_sec"] = real_tokens / max(metrics["epoch_seconds"], 1e-9)
        metrics["step_durations_s"] = list(timer.durations)
        metrics.update(timer.summary())
        if on_card:
            metrics["memory_peak_bytes_in_use"] = float(torch.cuda.max_memory_allocated(self.device))
        book_epoch(tel, self.epoch, metrics, timer.durations)
        return metrics

    def validate(self) -> Dict[str, float]:
        """Re-encode the anchors with the current (or EMA) weights, then
        score the validation corpus; the metrics come back under the
        reference's ``s_`` names."""
        if not (self.validation_path and self.anchor_path):
            return {}
        c = self.config
        target = self.ema_model if self.ema_model is not None else self.model
        if not hasattr(self, "_val_predictor"):
            from ..evaluate.predict_memory import SiamesePredictor

            self._val_predictor = SiamesePredictor(
                target, self.tokenizer, telemetry=get_registry(),
                batch_size=c.eval_batch_size,
                max_length=c.eval_max_length,
                buckets=tuple(c.eval_buckets) if c.eval_buckets else None,
                tokens_per_batch=c.eval_tokens_per_batch, mesh=self.mesh,
            )
        predictor = self._val_predictor
        predictor.model = target.eval()
        predictor.encode_anchors(self.reader.read_anchors(self.anchor_path))
        out_dir = (
            Path(c.serialization_dir) if c.serialization_dir
            else Path(tempfile.mkdtemp(prefix="memvul_val_"))
        )
        out = out_dir / f"validation_epoch_{self.epoch}.json"
        metrics = predictor.predict_file(self.reader, self.validation_path, out, split="validation")
        rename = {"f1": "s_f1-score"}
        return {rename.get(k, f"s_{k}"): v for k, v in metrics.items()}

    # -- preemption safety -----------------------------------------------------

    def _should_stop(self, at_sync: bool = True) -> bool:
        """Whether to stop now.  On a mesh of several ranks the ranks agree
        (a collective, so only where every rank is: after a drain, between
        epochs): a signal on any rank stops them all."""
        if self.mesh is None or self.mesh.world_size == 1:
            return self._stop_signal is not None
        if not at_sync:
            return False
        stop = any_rank(self._stop_signal is not None, self.mesh)
        if stop and self._stop_signal is None:
            self._stop_signal = int(signal.SIGTERM)  # a peer's signal
        return stop

    def _request_stop(self, signum, frame) -> None:
        """Signal handler: a flag only.  The step in flight finishes, the
        stats drain, and the trainer exits through a step checkpoint."""
        self._stop_signal = signum

    def _install_signal_handlers(self):
        """SIGTERM and SIGINT route to :meth:`_request_stop` while train()
        runs (only possible on the main thread)."""
        if threading.current_thread() is not threading.main_thread():
            return None
        previous = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous.append((sig, signal.signal(sig, self._request_stop)))
            except (ValueError, OSError):
                pass
        return previous

    @property
    def _preempt_marker(self) -> Optional[Path]:
        if self.config.serialization_dir is None:
            return None
        return Path(self.config.serialization_dir) / "PREEMPTED.json"

    def _save_step_checkpoint(self) -> None:
        """A mid-epoch checkpoint: the full state plus the stream position
        (epoch and stacks consumed), enough to replay the rest exactly."""
        if self.checkpointer is None or not self._writes:
            return
        self.checkpointer.save_step(
            self.step,
            self._state_dict(),
            metadata={
                "epoch": self.epoch,
                "step": self.step,
                "stacks_done": self._epoch_stacks_done,
                "epoch_seed": self._epoch_seed(self.epoch),
                "signal": self._stop_signal,
            },
        )
        logger.info(
            "step checkpoint: global step %d (epoch %d, %d stacks done)",
            self.step, self.epoch, self._epoch_stacks_done,
        )

    def _save_preemption_state(self) -> None:
        self._save_step_checkpoint()
        marker = self._preempt_marker
        if marker is not None and self._writes:
            atomic_write_text(marker, json.dumps({
                "signal": self._stop_signal, "epoch": self.epoch, "step": self.step,
                "stacks_done": self._epoch_stacks_done,
            }, indent=2))
        logger.warning("preempted by signal %s at step %d: resumable state saved",
                       self._stop_signal, self.step)
        tel = get_registry()
        tel.counter("train.preemptions").inc()
        tel.event("preempted", signal=self._stop_signal, epoch=self.epoch, step=self.step)
        tel.heartbeat(force=True)

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.maybe_restore()
        handlers = self._install_signal_handlers()
        preempted = False
        try:
            while self.epoch < c.num_epochs:
                if self._should_stop():
                    preempted = True
                    self._save_preemption_state()
                    break
                epoch_metrics: Dict[str, Any] = {"epoch": self.epoch}
                # profile_dir: a profiler trace of epoch 0 (the first epoch run)
                with trace_context(c.profile_dir if self.epoch == 0 else None):
                    train_metrics = self.train_epoch()
                if self._should_stop():
                    # a partial epoch: no validation, no epoch checkpoint;
                    # the resumed run finishes the epoch
                    preempted = True
                    self._save_preemption_state()
                    break
                epoch_metrics.update({f"training_{k}": v for k, v in train_metrics.items()})
                with get_registry().span("validate", epoch=self.epoch):
                    val = self.validate()
                epoch_metrics.update({f"validation_{k}": v for k, v in val.items()})
                self.metrics_history.append(epoch_metrics)
                logger.info("epoch %d: loss %.6f, %s", self.epoch, train_metrics["loss"],
                            {k: v for k, v in val.items() if isinstance(v, float)})
                is_best = True
                if val:
                    is_best = self.tracker.update(
                        {k.replace("validation_", ""): v for k, v in epoch_metrics.items()
                         if k.startswith("validation_")},
                        self.epoch,
                    )
                if self.checkpointer is not None and self._writes:
                    with get_registry().span("checkpoint", epoch=self.epoch):
                        self.checkpointer.save(
                            self.epoch, self._state_dict(), is_best=is_best,
                            metadata=epoch_metrics,
                        )
                self.epoch += 1
                self._epoch_stacks_done = 0
                if val and self.tracker.should_stop():
                    logger.info("early stopping at epoch %d", self.epoch)
                    break
        finally:
            for sig, old in handlers or ():
                try:
                    signal.signal(sig, old)
                except (ValueError, OSError):
                    pass
        marker = self._preempt_marker
        if not preempted and marker is not None and self._writes and marker.exists():
            marker.unlink()  # completed cleanly: the resumable marker is stale
        result: Dict[str, Any] = {
            "best_epoch": self.tracker.best_epoch,
            "best_validation": self.tracker.best,
            "history": self.metrics_history,
        }
        if preempted:
            result["preempted"] = True
            result["preempt_signal"] = self._stop_signal
        return result

    # -- state ----------------------------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        state = {
            "params": host_tree(self.model.state_dict()),
            "opt_state": host_tree(self.optimizer.state_dict()),
            "rng": self.generator.get_state(),
            "meta": {
                "step": self.step,
                "epoch": self.epoch,
                "stacks_done": self._epoch_stacks_done,
                "tracker": self.tracker.state_dict(),
            },
        }
        if self.ema_model is not None:
            state["ema_params"] = host_tree(self.ema_model.state_dict())
        return state

    def maybe_restore(self) -> bool:
        if self.checkpointer is None:
            return False
        restored = self.checkpointer.restore_latest()
        step_restored = self.checkpointer.restore_latest_step()
        # a step checkpoint belongs to an epoch in progress when it was
        # written; it wins only if no epoch checkpoint completed that epoch
        completed_epoch = restored[0] if restored is not None else -1
        mid_epoch = False
        if step_restored is not None:
            step_epoch = int(step_restored[1]["meta"]["epoch"])
            if step_epoch > completed_epoch:
                restored = step_restored
                mid_epoch = True
            else:
                logger.info("ignoring stale step checkpoint from epoch %d (epoch %d completed after it)",
                            step_epoch, completed_epoch)
        if restored is None:
            return False
        _, state = restored
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.generator.set_state(state["rng"])
        _seed_rank_generator(self.generator, int(self.config.seed), self.mesh,
                             int(state["meta"]["step"]))
        if self.ema_model is not None:
            # ema enabled after this checkpoint was written: seed it from
            # the restored live weights
            self.ema_model.load_state_dict(state.get("ema_params", state["params"]))
        meta = state["meta"]
        self.step = int(meta["step"])
        if mid_epoch:
            self.epoch = int(meta["epoch"])
            self._resume_skip_stacks = int(meta.get("stacks_done", 0))
        else:
            self.epoch = int(meta["epoch"]) + 1
            self._resume_skip_stacks = 0
        self.tracker.load_state_dict(dict(meta["tracker"]))
        self.metrics_history = []
        for i in range(self.epoch):
            f = self.checkpointer.directory / f"metrics_epoch_{i}.json"
            if f.exists():
                self.metrics_history.append(json.loads(f.read_text()))
        if mid_epoch:
            logger.info("restored mid-epoch step checkpoint: resuming epoch %d at stack %d (global step %d)",
                        self.epoch, self._resume_skip_stacks, self.step)
        else:
            logger.info("restored checkpoint at epoch %d", self.epoch - 1)
        return True

    def best_params(self) -> Dict[str, torch.Tensor]:
        """The best-by-validation weights (the EMA weights when averaging
        is on, since validation selected those) as a host state dict."""
        live = self.ema_model if self.ema_model is not None else self.model
        state = self.checkpointer.restore_best() if self.checkpointer is not None else None
        if state is None:
            return host_tree(live.state_dict())
        return state.get("ema_params", state["params"])
