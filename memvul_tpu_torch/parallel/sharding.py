"""Tensor-parallel sharding rules for the BERT encoder (the JAX package's
``parallel/sharding.py``), over the port's parameter names.

Attention heads and the FFN hidden dim are split over the ``model`` axis
(the Megatron layout): the q/k/v projections and the FFN up-projection
are column-parallel (their output features split), the attention output
and the FFN down-projection row-parallel (their input features split,
partial products summed by an ``all_reduce`` before the bias).  Each rank
then runs attention, the flash kernel included, on its local heads
(``num_heads / model``).  Parameters no rule matches are replicated
(embeddings, LayerNorms, the pooler, the heads).

A spec is a tuple with one entry per dim, an axis name or None (JAX's
``PartitionSpec``); the rules give the trailing dims and are padded with
None on the left.  torch ``Linear`` weights are ``[out, in]``, so the
column-parallel rules split dim 0 and the row-parallel ones dim 1, where
the JAX rules split the heads of ``[H, heads, Dh]`` and ``[heads, Dh, H]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, Mesh, replicate

Spec = Tuple[Optional[str], ...]

# (name substring, spec of the trailing dims); first match wins, so the
# attention output comes before the FFN output it contains
DEFAULT_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    ("attention.self.query.weight", (MODEL_AXIS, None)),
    ("attention.self.key.weight", (MODEL_AXIS, None)),
    ("attention.self.value.weight", (MODEL_AXIS, None)),
    ("attention.self.query.bias", (MODEL_AXIS,)),
    ("attention.self.key.bias", (MODEL_AXIS,)),
    ("attention.self.value.bias", (MODEL_AXIS,)),
    # row-parallel: the partial sums are all-reduced, the bias added once
    ("attention.output.dense.weight", (None, MODEL_AXIS)),
    ("intermediate.dense.weight", (MODEL_AXIS, None)),
    ("intermediate.dense.bias", (MODEL_AXIS,)),
    ("output.dense.weight", (None, MODEL_AXIS)),
)


def tp_spec_for(name: str, ndim: int, rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Spec:
    """The spec of one parameter (all None, replicated, when no rule hits
    or a rule has more dims than the parameter)."""
    for needle, trailing in rules:
        if needle in name:
            if len(trailing) > ndim:
                return (None,) * ndim
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return (None,) * ndim


def param_specs(model: torch.nn.Module, rules=DEFAULT_TP_RULES):
    """{name: spec} over ``model.named_parameters()``."""
    return {name: tp_spec_for(name, p.ndim, rules) for name, p in model.named_parameters()}


def sharded_dim(spec: Spec) -> Optional[int]:
    return next((i for i, axis in enumerate(spec) if axis == MODEL_AXIS), None)


def validate_divisibility(model: torch.nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES) -> List[str]:
    """The parameters whose sharded dim the model axis does not divide."""
    if MODEL_AXIS not in mesh.axis_names:
        return []
    size = mesh.size(MODEL_AXIS)
    bad = []
    for name, p in model.named_parameters():
        dim = sharded_dim(tp_spec_for(name, p.ndim, rules))
        if dim is not None and p.shape[dim] % size:
            bad.append(f"{name}[{dim}]={p.shape[dim]} % {size}")
    # heads split whole: a rank's q/k/v columns must be whole heads
    cfg = getattr(model, "config", None)
    heads = getattr(cfg, "num_heads", None)
    if heads is not None and heads % size:
        bad.append(f"num_heads={heads} % {size}")
    return bad


def shard_params(model: torch.nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES) -> torch.nn.Module:
    """Broadcast ``model`` from rank 0, then (with a ``model`` axis) keep
    this rank's slice of every ruled parameter in place and bind the
    model group to each encoder layer, whose forward then runs the local
    heads and reduces the row-parallel products.  Without a ``model``
    axis, replication only."""
    replicate(model, mesh)
    if mesh.size(MODEL_AXIS) == 1:
        return model
    from ..models.lfm2 import is_lfm2, refuse

    if is_lfm2(getattr(model, "config", None)):
        refuse("tensor-parallel rules (a model axis)")
    bad = validate_divisibility(model, mesh, rules)
    if bad:
        raise ValueError(f"tensor parallelism over model={mesh.size(MODEL_AXIS)}: {bad}")
    if getattr(getattr(model, "config", None), "quant", None) is not None:
        raise ValueError("tensor parallelism shards float weights: the int8 tier is not sharded")
    n, j = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = sharded_dim(tp_spec_for(name, p.ndim, rules))
            if dim is not None:
                p.data = p.data.chunk(n, dim=dim)[j].contiguous()
    from ..models.bert import BertAttention, BertLayer

    for m in model.modules():
        if isinstance(m, (BertAttention, BertLayer)):
            m.tp_group = mesh[MODEL_AXIS]
    model.tp_specs = {name: tp_spec_for(name, p.ndim, rules) for name, p in model.named_parameters()}
    return model


def tp_norm_fn(model: torch.nn.Module, params: Sequence[torch.Tensor], mesh: Mesh):
    """The global gradient norm of a tensor-parallel model, as a
    ``GroupedAdamW.norm_fn`` over ``params`` (the optimizer's order): the
    sharded parameters' squares summed over the model group, the
    replicated ones counted once."""
    sharded_ids = {id(p) for name, p in model.named_parameters()
                   if sharded_dim(model.tp_specs[name]) is not None}
    sharded = [id(p) in sharded_ids for p in params]
    group = mesh[MODEL_AXIS]

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        parts = torch.zeros(2, dtype=torch.float32, device=grads[0].device)
        for is_sharded, g in zip(sharded, grads):
            parts[0 if is_sharded else 1] += g.to(torch.float32).pow(2).sum()
        whole = parts[1].clone()
        dist.all_reduce(parts, group=group)
        return torch.sqrt(parts[0] + whole)

    return norm


# -- the column- and row-parallel boundaries (Megatron's f and g) ------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (the input of
    a column-parallel projection is replicated, each rank's gradient a
    partial one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """The partial products of a row-parallel projection summed over the
    group, in f32 (one rounding to the compute dtype, as one device's
    product has); the gradient passes through (it is already replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.to(torch.float32).contiguous().clone()
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)
