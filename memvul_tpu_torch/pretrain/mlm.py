"""Whole-word-mask MLM further pretraining (the JAX package's
``pretrain/mlm.py``).

The reference further-pretrains BERT with HF's ``run_mlm_wwm.py`` over
one report per line (mask probability 0.15, batch 16 × accumulation 2)
and loads the resulting encoder into the classifiers.  Here:

* :func:`whole_word_mask` masks whole words (a wordpiece and its ``##``
  continuations), 80% → [MASK], 10% → a random id, 10% unchanged; with the
  same ``np.random.Generator`` it gives the JAX package's masks bit for bit;
* :class:`MLMModel` is the port's encoder with the BERT MLM head (dense,
  exact GELU, LayerNorm) and a decoder tied to the word-embedding table:
  the same ``Parameter`` serves both, so it gets the gradient of both
  uses.  ``attention_impl="flash"`` runs the hand-written attention kernel
  under autograd (at attention dropout 0; with dropout the encoder takes
  the plain attention, as the reference does);
* :class:`MLMTrainer` tokenizes the corpus once, feeds ``[K, B, L]``
  microbatch stacks from a prefetch thread (masking and the H2D copy off
  the critical path), divides the summed gradients by the number of
  stacks that hold a masked token, and steps the optax chain
  ``clip_by_global_norm(1.0) → scale_by_adam → linear_with_warmup →
  scale(-lr)`` (AdamW without weight decay).  Losses stay on the device
  for ``sync_every`` updates, then one transfer with the NaN guard;
  ``debug_checks`` checks each update finite first, and
  ``step.<global step>`` is a chaos point.
  ``output_dir`` checkpoints every epoch and resumes; a non-empty
  directory without checkpoints is refused unless
  ``overwrite_output_dir``;
* :func:`extract_encoder_params` / :func:`transplant_encoder` carry the
  pretrained encoder into a memory or single model, refusing a
  vocabulary-size change.

Dropout masks come from a ``torch.Generator``, so a trajectory matches
the JAX trainer's only at dropout 0.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.bert import BertConfig, BertEncoder, init_weights, layer_norm, linear
from ..resilience import faults
from ..training.metrics import check_finite, drain_pending

logger = logging.getLogger(__name__)

IGNORE = -100


# -- masking -----------------------------------------------------------------


def continuation_flags(tokenizer) -> np.ndarray:
    """[V] bool: True for ``##`` continuation wordpieces (added tokens
    included, as ``tokenizers``' ``get_vocab()`` lists them)."""
    flags = np.zeros(tokenizer.vocab_size, dtype=bool)
    for token, idx in tokenizer.get_vocab().items():
        if token.startswith("##"):
            flags[idx] = True
    return flags


def whole_word_mask(
    ids: np.ndarray,
    attention_mask: np.ndarray,
    rng: np.random.Generator,
    mask_id: int,
    vocab_size: int,
    continuation: np.ndarray,
    special_ids: Iterable[int],
    mask_prob: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    """HF ``DataCollatorForWholeWordMask`` semantics over a [B, L] batch:
    about ``mask_prob`` of each row's words are chosen (at least one when
    it has any: one uniform score per word, the ``n_mask`` smallest win);
    of the chosen tokens 80% become [MASK], 10% a random id, 10% stay.
    Returns (masked ids, labels), labels ``IGNORE`` off the chosen set.  A
    continuation with no head before it starts its own word."""
    B, L = ids.shape
    special = np.asarray(sorted(int(s) for s in special_ids), dtype=ids.dtype)
    maskable = (attention_mask > 0) & ~np.isin(ids, special)
    is_cont = np.zeros((B, L), dtype=bool)
    np.copyto(is_cont, continuation[ids], where=maskable)
    head = maskable & ~is_cont
    first = maskable & (np.cumsum(maskable, axis=1) == 1)
    head |= first
    word_idx = np.cumsum(head, axis=1) - 1  # [B, L], -1 before any head
    n_words = head.sum(axis=1)
    max_words = int(n_words.max()) if B else 0
    masked = ids.copy()
    labels = np.full_like(ids, IGNORE)
    if max_words == 0:
        return masked, labels
    n_mask = np.maximum(1, np.round(n_words * mask_prob).astype(np.int64))
    n_mask = np.where(n_words > 0, np.minimum(n_mask, n_words), 0)
    scores = rng.random((B, max_words))
    scores[np.arange(max_words)[None, :] >= n_words[:, None]] = np.inf
    ranks = scores.argsort(axis=1).argsort(axis=1)
    chosen_word = ranks < n_mask[:, None]
    safe_idx = np.clip(word_idx, 0, max_words - 1)
    chosen = maskable & (word_idx >= 0) & np.take_along_axis(chosen_word, safe_idx, axis=1)
    labels[chosen] = ids[chosen]
    roll = rng.random((B, L))
    rand_ids = rng.integers(0, vocab_size, size=(B, L), dtype=ids.dtype)
    masked = np.where(chosen & (roll < 0.8), mask_id, masked)
    masked = np.where(chosen & (roll >= 0.8) & (roll < 0.9), rand_ids, masked)
    return masked, labels


# -- model -------------------------------------------------------------------


class MLMModel(nn.Module):
    """BERT encoder + transform head + a decoder tied to the word-embedding
    table (HF ``BertForMaskedLM``'s layout).  Parameters f32, computed in
    ``config.dtype``; the logits come out in it."""

    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.transform_LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, initializer_range) weights and embeddings, zero biases (the
        decoder's too), unit LayerNorm scales."""
        with torch.no_grad():
            init_weights(self, self.config.initializer_range, generator=generator)
            self.decoder_bias.zero_()

    def forward(self, input_ids, attention_mask, generator: Optional[torch.Generator] = None):
        c = self.config
        hidden = self.bert(input_ids, attention_mask, generator=generator)
        x = F.gelu(linear(hidden, self.transform, c.dtype))  # exact (erf)
        x = layer_norm(x, self.transform_LayerNorm, c.dtype)
        table = self.bert.embeddings.word_embeddings.weight
        logits = torch.matmul(x, table.t().to(x.dtype))
        return logits + self.decoder_bias.to(logits.dtype)


def mlm_nll_sums(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL over the supervised positions, their count): the one
    masked-LM arithmetic, shared by the training loss (a mean) and held-out
    evaluation (corpus-weighted).  ``log_softmax`` in f32."""
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.where(labels == IGNORE, torch.zeros_like(labels), labels).long()
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not IGNORE."""
    nll_sum, count = mlm_nll_sums(logits, labels)
    return nll_sum / count.clamp_min(1.0)


# -- params plumbing ---------------------------------------------------------


def extract_encoder_params(model: MLMModel) -> Dict[str, torch.Tensor]:
    """The encoder of an MLM model as a host f32 state dict (HF
    ``BertModel`` keys, the ``bert`` subtree of the JAX package's tree)."""
    return {k: v.detach().to(torch.float32).cpu() for k, v in model.bert.state_dict().items()}


def transplant_encoder(classifier: nn.Module, encoder: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a pretrained encoder (:func:`extract_encoder_params`) into a
    memory or single model's ``bert``.  A vocabulary-size change between
    pretraining and fine-tuning raises (a table of another size would
    index other rows for the same ids), as does any other tensor of
    another shape.  Returns the model."""
    want = classifier.bert.embeddings.word_embeddings.weight.shape[0]
    got = encoder["embeddings.word_embeddings.weight"].shape[0]
    if want != got:
        raise ValueError(
            f"pretrained encoder vocab size {got} != classifier vocab size {want}; the "
            "tokenizer changed between pretraining and fine-tuning (did data/vocab.txt "
            "appear after the MLM run?)"
        )
    target = classifier.bert.state_dict()
    misfit = sorted(k for k in set(target) | set(encoder)
                    if k not in target or k not in encoder
                    or tuple(target[k].shape) != tuple(encoder[k].shape))
    if misfit:
        raise ValueError(
            f"pretrained encoder does not fit the model's encoder at {misfit[:4]}"
            f"{' …' if len(misfit) > 4 else ''}: pretrain with the encoder geometry "
            "(positions, width, depth, ScalarMix) of the model that loads it"
        )
    device = classifier.bert.embeddings.word_embeddings.weight.device
    classifier.bert.load_state_dict({k: v.to(device) for k, v in encoder.items()})
    return classifier


def mlm_train_step(
    model: MLMModel, optimizer, ids: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    debug_checks: bool = False,
) -> torch.Tensor:
    """One optimizer update over a [K, B, L] stack: each microbatch's
    forward and backward (gradients summed), the sum divided by the number
    of microbatches that hold a masked token (an epoch tail's all-padding
    microbatches do not dilute it), then the clipped update (with
    ``debug_checks``, checked finite first).  Returns the mean loss over
    those microbatches, on the device."""
    optimizer.zero_grad()
    loss_sum = torch.zeros((), dtype=torch.float32, device=ids.device)
    real = torch.zeros((), dtype=torch.float32, device=ids.device)
    for i in range(ids.shape[0]):
        loss = mlm_loss(model(ids[i], mask[i], generator=generator), labels[i])
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        real = real + (labels[i] != IGNORE).any().to(torch.float32)
    real = real.clamp_min(1.0)
    with torch.no_grad():
        for p in optimizer.params:
            p.grad.div_(real)
        if debug_checks:
            check_finite(loss_sum / real, model.named_parameters())
        optimizer.step()
    return loss_sum / real


# -- trainer -----------------------------------------------------------------


@dataclasses.dataclass
class MLMTrainerConfig:
    """Every field of the JAX package's ``MLMTrainerConfig`` (the
    ``trainer`` section of a pretrain config)."""

    batch_size: int = 16
    grad_accum: int = 2
    max_length: int = 256
    mask_prob: float = 0.15
    learning_rate: float = 5e-5
    warmup_steps: int = 50000
    num_epochs: int = 50
    seed: int = 2021
    steps_per_epoch: Optional[int] = None
    output_dir: Optional[str] = None  # enables checkpoints and resume
    overwrite_output_dir: bool = False
    # updates run ahead before their losses are pulled to the host (the
    # NaN guard fires there); 1 syncs every update
    sync_every: int = 32
    # the JAX package's checkify float checks (check_finite before each update)
    debug_checks: bool = False
    # stacks masked and copied to the device ahead of the update (>= 1)
    prefetch_depth: int = 4


def read_corpus_lines(path) -> List[str]:
    """The corpus's non-blank lines; an effectively empty file raises.
    Training, held-out evaluation and the CLI's fail-fast check share it."""
    with open(path, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        raise ValueError(f"MLM corpus {path} is empty")
    return lines


class MLMTrainer:
    """Further-pretrains an :class:`MLMModel` of ``config`` (weights drawn
    from ``trainer_config.seed``) on ``device``."""

    def __init__(
        self,
        config: BertConfig,
        tokenizer,
        trainer_config: Optional[MLMTrainerConfig] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        from ..build import resolve_device
        from ..training.optim import make_optimizer

        self.device = resolve_device(device)
        c = self.c = trainer_config or MLMTrainerConfig()
        if config.quant is not None:
            raise ValueError(
                f"encoder quant={config.quant!r} is inference-only: pretrain full precision"
            )
        if int(c.prefetch_depth) < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {c.prefetch_depth}")
        self.tokenizer = tokenizer
        self._continuation = continuation_flags(tokenizer)
        self._special = [tokenizer.pad_id, tokenizer.cls_id, tokenizer.sep_id]
        self._np_rng = np.random.default_rng(c.seed)
        self.model = MLMModel(config)
        self.model.init_weights(torch.Generator().manual_seed(int(c.seed)))
        self.model.to(self.device)
        # no groups, no weight decay: optax's clip → adam → schedule → -lr
        self.optimizer = make_optimizer(
            self.model.named_parameters(), group_lrs={}, group_rules=(),
            base_lr=c.learning_rate, grad_clip_norm=1.0, weight_decay=0.0,
            lr_schedule={"type": "linear_with_warmup", "warmup_steps": c.warmup_steps},
        )
        self.generator = torch.Generator(device=self.device).manual_seed(int(c.seed))
        self.step = 0
        self.start_epoch = 0
        self.checkpointer = None
        if c.output_dir is not None:
            self._init_output_dir()

    # -- checkpoint / resume --------------------------------------------------

    def _init_output_dir(self) -> None:
        from ..training.checkpoint import TrainCheckpointer

        out = Path(self.c.output_dir)
        if (out.exists() and any(out.iterdir()) and not (out / "epochs").exists()
                and not self.c.overwrite_output_dir):
            raise ValueError(
                f"output dir {out} exists and is not empty; pass overwrite_output_dir=True "
                "to overwrite, or point at a directory with checkpoints to resume"
            )
        self.checkpointer = TrainCheckpointer(out)

    def _state_dict(self, epoch: int = 0) -> Dict:
        return {
            "params": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
            "meta": {"step": self.step, "epoch": epoch},
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
        self.step = int(state["meta"]["step"])
        self.start_epoch = int(state["meta"]["epoch"]) + 1
        logger.info("mlm: resumed after epoch %d", self.start_epoch - 1)
        return True

    # -- data ------------------------------------------------------------------

    def _encode_corpus(self, lines: List[str]) -> None:
        """Tokenize the whole corpus once into a packed (flat ids, offsets)
        pair; every epoch afterwards only shuffles and masks."""
        started = time.perf_counter()
        seqs = [np.asarray(s, np.int32) for s in self.tokenizer.encode_many(
            lines, max_length=self.c.max_length)]
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(s) for s in seqs])
        self._flat_ids = np.concatenate(seqs) if seqs else np.zeros(0, np.int32)
        self._offsets = offsets
        logger.info("mlm: tokenized %d lines (%d tokens) in %.1fs, kept for every epoch",
                    len(lines), len(self._flat_ids), time.perf_counter() - started)

    @property
    def corpus_size(self) -> int:
        return len(self._offsets) - 1 if hasattr(self, "_offsets") else 0

    def _batches(self, rng: Optional[np.random.Generator] = None) -> Iterator[Tuple[np.ndarray, ...]]:
        """[K, B, L] stacks (K = grad_accum) of (masked ids, attention
        mask, labels) in a permutation of the corpus; the last stack is
        filled with empty rows, which hold no masked token.  ``rng`` (the
        epoch's generator) shuffles and masks."""
        c = self.c
        rng = self._np_rng if rng is None else rng
        rows = c.batch_size * max(1, c.grad_accum)
        order = rng.permutation(self.corpus_size)
        shape = (max(1, c.grad_accum), c.batch_size, c.max_length)
        for start in range(0, self.corpus_size, rows):
            seqs = [self._flat_ids[self._offsets[i]: self._offsets[i + 1]]
                    for i in order[start: start + rows]]
            masked, mask, labels = self._masked_rows(seqs, rows, rng)
            yield masked.reshape(shape), mask.reshape(shape), labels.reshape(shape)

    def _masked_rows(
        self, seqs: List[np.ndarray], rows: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(masked ids, attention mask, labels) for up to ``rows`` padded
        sequences: the one batch layout of training and evaluation."""
        c = self.c
        ids = np.full((rows, c.max_length), self.tokenizer.pad_id, np.int32)
        mask = np.zeros_like(ids)
        for i, seq in enumerate(seqs):
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        masked, labels = whole_word_mask(
            ids, mask, rng, self.tokenizer.mask_id, self.tokenizer.vocab_size,
            self._continuation, self._special, c.mask_prob,
        )
        return masked, mask, labels

    def _commit(self, item: Tuple[np.ndarray, ...]) -> Tuple[torch.Tensor, ...]:
        """The host-to-device copy of a stack (on the prefetch thread)."""
        from ..training.trainer import to_device

        return tuple(to_device(x, self.device) for x in item)

    # -- evaluation --------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, corpus_path: str, seed: int = 0) -> Dict[str, float]:
        """Held-out masked-LM loss and perplexity (the reference script's
        ``do_eval``): masks from a fixed ``seed``, the mean weighted by the
        count of masked tokens."""
        c = self.c
        lines = read_corpus_lines(corpus_path)
        rng = np.random.default_rng(seed)
        self.model.eval()
        nll = torch.zeros((), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        for start in range(0, len(lines), c.batch_size):
            seqs = [np.asarray(s, np.int32) for s in self.tokenizer.encode_many(
                lines[start: start + c.batch_size], max_length=c.max_length)]
            masked, mask, labels = self._commit(self._masked_rows(seqs, c.batch_size, rng))
            s, k = mlm_nll_sums(self.model(masked, mask), labels)
            nll += s
            count += k
        total, masked_total = float(nll), float(count)
        loss = total / max(masked_total, 1.0)
        return {
            "eval_loss": loss,
            "perplexity": math.exp(min(loss, 30.0)),
            "eval_lines": len(lines),
            "masked_tokens": int(masked_total),
        }

    # -- training ------------------------------------------------------------------

    def train(self, corpus_path: str) -> Dict:
        """Every epoch from the restored one on.  Returns ``final_loss``,
        the per-epoch mean losses (``history``) and, per epoch, its
        updates' losses, wall seconds (a drain's wait spread over the
        updates it covers) and padded and real token counts."""
        from ..data.batching import prefetch
        from ..training.trainer import _fetch_stats
        from ..utils.profiling import StepTimer

        c = self.c
        self._encode_corpus(read_corpus_lines(corpus_path))
        self.maybe_restore()
        history: List[float] = []
        epochs: List[Dict] = []
        for epoch in range(self.start_epoch, c.num_epochs):
            self.model.train()
            losses: List[float] = []
            pending: List[Dict[str, torch.Tensor]] = []
            timer = StepTimer()
            padded = real = 0
            started = time.perf_counter()
            # a generator per epoch, drawn on this thread: the prefetch
            # worker owns it alone
            epoch_rng = np.random.default_rng(self._np_rng.integers(2**63))
            feed = prefetch(self._batches(epoch_rng), depth=int(c.prefetch_depth),
                            commit=lambda item: (self._commit(item), int(item[1].sum())))
            for i, ((ids, mask, labels), live) in enumerate(feed):
                if c.steps_per_epoch is not None and i >= c.steps_per_epoch:
                    break
                padded += ids.numel()
                real += live
                # chaos: "step.<global step>" fires as the update starts
                faults.fault_point(f"step.{self.step}")
                with timer.step():
                    pending.append({"loss": mlm_train_step(
                        self.model, self.optimizer, ids, mask, labels, self.generator,
                        c.debug_checks)})
                    self.step += 1
                if len(pending) >= max(1, c.sync_every):
                    with timer.distribute_over_last(len(pending)):
                        drain_pending(pending, _fetch_stats, self.step, losses, what="MLM loss")
            if pending:
                with timer.distribute_over_last(len(pending)):
                    drain_pending(pending, _fetch_stats, self.step, losses, what="MLM loss")
            mean_loss = float(np.mean(losses)) if losses else 0.0
            history.append(mean_loss)
            seconds = time.perf_counter() - started
            epochs.append({"epoch": epoch, "loss": mean_loss, "losses": losses, "seconds": seconds,
                           "step_durations_s": list(timer.durations), "padded_tokens": padded,
                           "real_tokens": real})
            logger.info("mlm epoch %d: loss %.4f (%.1fs)", epoch, mean_loss, seconds)
            if self.checkpointer is not None:
                self.checkpointer.save(epoch, self._state_dict(epoch), metadata={"loss": mean_loss})
        return {"final_loss": history[-1] if history else 0.0, "history": history,
                "epochs": epochs}

    def encoder_params(self) -> Dict[str, torch.Tensor]:
        return extract_encoder_params(self.model)
