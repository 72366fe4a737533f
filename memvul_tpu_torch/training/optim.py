"""Optimizers: parameter-group AdamW and the schedule family (the JAX
package's ``training/optim.py``, there in optax).

The reference trains with AdamW in parameter groups (the BERT encoder at
2e-5, the pooler at 5e-5, everything else at ``base_lr``), a
linear-with-warmup schedule and grad-norm clipping.  Schedules here are
plain step → scale functions; :func:`make_optimizer` builds one
``torch.optim.AdamW`` with a param group per label, stepped by a
``LambdaLR``, inside :class:`GroupedAdamW`, which keeps optax's order:

* the global-norm clip runs first, over every gradient, with optax's
  arithmetic (``g / norm * max_norm`` where ``norm >= max_norm``, no
  ``1e-6`` in the divisor, unlike ``clip_grad_norm_``);
* the scale of update ``n`` (counting from 0) is ``schedule(n)``, so with
  a warmup the first update is scaled by ``schedule(0) = 0``, as optax's
  ``scale_by_schedule`` does;
* weight decay is decoupled and scaled by lr × schedule (AdamW's own);
* a momentum schedule sets ``betas[0]`` to ``momentum(n)`` before update
  ``n`` (optax's ``inject_hyperparams``), and Adam's bias correction
  uses it, as optax's does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def linear_with_warmup(warmup_steps: int, total_steps: Optional[int] = None) -> Schedule:
    """0 → 1 linearly over ``warmup_steps``, then (with ``total_steps``)
    linearly down to 0; without ``total_steps`` it stays at 1."""

    def schedule(step: int) -> float:
        warm = min(1.0, step / max(1.0, float(warmup_steps)))
        if total_steps is None:
            return warm
        if step < warmup_steps:
            return warm
        return max(0.0, (total_steps - step) / max(1.0, float(total_steps - warmup_steps)))

    return schedule


def make_schedule(spec: Dict) -> Schedule:
    """``{"type": ..., ...}`` → a step → scale schedule in [0, 1]:
    ``constant``; ``linear_with_warmup`` (warmup_steps, total_steps);
    ``slanted_triangular`` (num_steps, cut_frac=0.1, ratio=32);
    ``cosine_with_warmup`` and ``polynomial_decay`` (warmup_steps,
    total_steps; power=1.0, end_factor=0.0)."""
    kind = spec.get("type", "linear_with_warmup")
    warmup = float(spec.get("warmup_steps", 0))
    total = spec.get("total_steps", spec.get("num_steps"))

    if kind == "constant":
        return lambda step: 1.0
    if kind == "linear_with_warmup":
        return linear_with_warmup(int(warmup), total)
    if kind == "slanted_triangular":
        if total is None:
            raise ValueError("slanted_triangular needs num_steps/total_steps")
        cut_frac = float(spec.get("cut_frac", 0.1))
        ratio = float(spec.get("ratio", 32))
        cut = max(1.0, float(total) * cut_frac)

        def stlr(step: int) -> float:
            if step < cut:
                p = step / cut
            else:
                p = 1.0 - (step - cut) / max(1.0, float(total) - cut)
            p = min(1.0, max(0.0, p))
            return (1.0 + p * (ratio - 1.0)) / ratio

        return stlr

    def warmup_then(decay: Callable[[float], float]) -> Schedule:
        """Linear warmup to 1, then ``decay(progress)``, progress 0 → 1
        (clipped) over the post-warmup steps."""
        if total is None:
            raise ValueError(f"{kind} needs total_steps")

        def schedule(step: int) -> float:
            if step < warmup:
                return step / max(1.0, warmup)
            progress = min(1.0, max(0.0, (step - warmup) / max(1.0, float(total) - warmup)))
            return decay(progress)

        return schedule

    if kind == "cosine_with_warmup":
        return warmup_then(lambda p: 0.5 * (1.0 + math.cos(math.pi * p)))
    if kind == "polynomial_decay":
        power = float(spec.get("power", 1.0))
        end = float(spec.get("end_factor", 0.0))
        return warmup_then(lambda p: (1.0 - p) ** power * (1.0 - end) + end)
    raise ValueError(f"unknown schedule type {kind!r}")


def make_momentum_schedule(spec: Dict, base: float = 0.9) -> Schedule:
    """AdamW's b1 per step: ``inverted_triangular`` ramps from ``base``
    down to ``low`` over ``cooldown_steps``, back up over
    ``warmup_steps``, then holds; ``constant`` holds ``base``."""
    kind = spec.get("type", "inverted_triangular")
    if kind == "constant":
        return lambda step: base
    if kind != "inverted_triangular":
        raise ValueError(f"unknown momentum schedule type {kind!r}")
    low = float(spec.get("low", 0.85))
    cooldown = float(spec.get("cooldown_steps", spec.get("cooldown", 1)))
    warmup = float(spec.get("warmup_steps", spec.get("warmup", 1)))

    def schedule(step: int) -> float:
        if step < cooldown:
            return base + (low - base) * step / max(1.0, cooldown)
        if step < cooldown + warmup:
            return low + (base - low) * (step - cooldown) / max(1.0, warmup)
        return base

    return schedule


# parameter-name prefixes → group labels: the port's counterparts of the
# flax paths ``bert/`` and ``pooler/``
DEFAULT_GROUP_RULES: Tuple[Tuple[str, str], ...] = (("bert.", "embedder"), ("pooler.", "pooler"))


def label_params(
    names: Iterable[str], rules: Sequence[Tuple[str, str]] = DEFAULT_GROUP_RULES,
    default: str = "default",
) -> Dict[str, str]:
    """Each parameter name's group label: the first rule whose prefix it
    starts with, else ``default``."""
    out = {}
    for name in names:
        out[name] = next((label for prefix, label in rules if name.startswith(prefix)), default)
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over every element, in f32 (optax's ``global_norm``)."""
    return torch.sqrt(sum(t.to(torch.float32).pow(2).sum() for t in tensors))


class GroupedAdamW:
    """AdamW in parameter groups, stepped by a ``LambdaLR``: the port's
    counterpart of :func:`make_optimizer`'s optax chain.

    :meth:`step` clips the gradients in place, sets ``betas[0]`` from the
    momentum schedule, runs the AdamW update and advances the schedule;
    it returns the pre-clip global norm as a device tensor (no host
    sync)."""

    def __init__(
        self,
        optimizer: torch.optim.AdamW,
        scheduler: torch.optim.lr_scheduler.LambdaLR,
        grad_clip_norm: Optional[float],
        momentum: Optional[Schedule],
        betas: Tuple[float, float],
    ) -> None:
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_clip_norm = grad_clip_norm
        self.momentum = momentum
        self.betas = betas
        self.params: List[torch.Tensor] = [p for g in optimizer.param_groups for p in g["params"]]

    @property
    def count(self) -> int:
        """Updates taken so far (optax's schedule count)."""
        return int(self.scheduler.last_epoch)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=False)

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            max_norm = float(self.grad_clip_norm)
            trigger = norm < max_norm
            for g in grads:
                g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * max_norm))
        if self.momentum is not None:
            b1 = float(self.momentum(self.count))
            for group in self.optimizer.param_groups:
                group["betas"] = (b1, self.betas[1])
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    group_lrs: Optional[Dict[str, float]] = None,
    group_rules: Optional[Sequence[Tuple[str, str]]] = None,
    base_lr: float = 1e-4,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    betas: Tuple[float, float] = (0.9, 0.999),
    weight_decay: float = 0.0,
    grad_clip_norm: Optional[float] = 1.0,
    lr_schedule: Optional[Dict] = None,
    momentum_schedule: Optional[Dict] = None,
) -> GroupedAdamW:
    """The reference's optimizer: the encoder (``bert.``) at 2e-5, the
    pooler (``pooler.``) at 5e-5, the rest at ``base_lr`` unless
    ``group_lrs`` says otherwise; ``lr_schedule`` (a :func:`make_schedule`
    spec) replaces the default linear warmup (and decay, with
    ``total_steps``); ``momentum_schedule`` drives b1 per step."""
    if group_rules is None:
        group_rules = DEFAULT_GROUP_RULES
    if group_lrs is None:
        group_lrs = {"embedder": 2e-5, "pooler": 5e-5}
    if lr_schedule is not None:
        spec = dict(lr_schedule)
        spec.setdefault("warmup_steps", warmup_steps)
        spec.setdefault("total_steps", total_steps)
        schedule = make_schedule(spec)
    elif warmup_steps or total_steps is not None:
        schedule = linear_with_warmup(warmup_steps, total_steps)
    else:
        schedule = lambda step: 1.0  # noqa: E731
    named = list(named_params)
    labels = label_params((n for n, _ in named), group_rules)
    lrs = dict(group_lrs)
    lrs["default"] = base_lr
    groups = []
    for label, lr in lrs.items():
        params = [p for n, p in named if labels[n] == label]
        if params:
            groups.append({"params": params, "lr": float(lr), "label": label})
    unknown = set(labels.values()) - set(lrs)
    if unknown:
        raise ValueError(f"parameter groups {sorted(unknown)} have no learning rate")
    optimizer = torch.optim.AdamW(groups, betas=betas, eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: float(schedule(step)))
    momentum = (
        make_momentum_schedule(momentum_schedule, base=betas[0])
        if momentum_schedule is not None else None
    )
    return GroupedAdamW(optimizer, scheduler, grad_clip_norm, momentum, betas)
