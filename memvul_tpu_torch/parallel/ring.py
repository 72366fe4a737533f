"""Sequence-parallel ring attention over a mesh axis (the JAX package's
``parallel/ring.py``).

The sequence axis is sharded over the ranks of the ``seq`` group: each
rank holds a query block plus one key/value block, and the key/value
blocks (with their key bias) travel around the ring by
``dist.batch_isend_irecv`` while an online-softmax accumulator builds the
exact full-sequence attention.  The transfer of the next block is posted
before the current block's math, so the two overlap.

Numerics follow JAX's: scores in the query dtype, the accumulation in
f32 with the running max and denominator, no closing rotation, and zeros
for a query row whose keys are masked in every block.  The block math is
plain PyTorch (JAX computes it with ``einsum`` outside any Pallas
kernel).  :class:`RingAttentionFunction` gives the op its backward: a
second ring pass that recomputes each block's probabilities from the
saved log-sum-exp and carries the block's dK and dV along with it, home
to their rank after the last block.

* :func:`ring_attention`: the per-rank op, over ``group``;
* :func:`make_ring_attention`: binds a mesh axis, ``fn(q, k, v, mask)``;
* :func:`encode_sequence_parallel`: a ``BertEncoder`` built with
  ``attention_impl="ring"`` over this rank's slice of the sequence, with
  global position ids (the encoder's attention finds the group through
  :func:`ring_group`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import SEQ_AXIS, Mesh

_bound = threading.local()


@contextlib.contextmanager
def ring_group(group):
    """Bind the process group the encoder's ``"ring"`` attention rotates
    over (``shard_map``'s bound axis name in the JAX package)."""
    previous = getattr(_bound, "group", None)
    _bound.group = group
    try:
        yield group
    finally:
        _bound.group = previous


def current_group():
    group = getattr(_bound, "group", None)
    if group is None:
        raise RuntimeError(
            "attention_impl='ring' runs inside encode_sequence_parallel (or ring_group), "
            "which binds the sequence axis's process group"
        )
    return group


def _key_bias(key, key_mask, key_bias) -> torch.Tensor:
    """The travelling [B, 1, 1, T_k] f32 bias, from ``key_bias`` (key-only:
    its head and query dims must broadcast) or ``key_mask``."""
    b, t_k = key.shape[:2]
    neg = torch.finfo(torch.float32).min
    if key_bias is not None:
        for dim in (-3, -2):
            if key_bias.ndim >= -dim and key_bias.shape[dim] != 1:
                raise ValueError(
                    "ring attention supports key-only bias (broadcastable "
                    f"to [B, 1, 1, T_k]); got shape {tuple(key_bias.shape)}"
                )
        return torch.broadcast_to(key_bias.to(torch.float32), (b, 1, 1, t_k)).contiguous()
    if key_mask is None:
        key_mask = torch.ones((b, t_k), dtype=torch.int32, device=key.device)
    zero = torch.zeros((), dtype=torch.float32, device=key.device)
    fill = torch.full((), neg, dtype=torch.float32, device=key.device)
    return torch.where(key_mask[:, None, None, :] > 0, zero, fill)


class _Ring:
    """The group's ring: this rank's neighbours as global ranks, and the
    posted rotation of a list of tensors to the next rank."""

    def __init__(self, group) -> None:
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        if self.size > 1:
            me = dist.get_rank(group)
            self.next = dist.get_global_rank(group, (me + 1) % self.size)
            self.prev = dist.get_global_rank(group, (me - 1) % self.size)

    def post(self, tensors: List[torch.Tensor]):
        """Send ``tensors`` to the next rank and receive the previous
        rank's into new buffers; returns (works, buffers)."""
        bufs = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, b, self.prev, self.group) for b in bufs]
        return dist.batch_isend_irecv(ops), bufs

    @staticmethod
    def wait(works) -> None:
        for w in works:
            w.wait()


def _forward(query, key, value, kb, ring: _Ring):
    depth = query.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(depth, dtype=torch.float32)).item()
    neg = torch.finfo(torch.float32).min
    b, t_q, h, _ = query.shape
    acc = torch.zeros((b, t_q, h, depth), dtype=torch.float32, device=query.device)
    row_max = torch.full((b, h, t_q), neg, dtype=torch.float32, device=query.device)
    denom = torch.zeros((b, h, t_q), dtype=torch.float32, device=query.device)
    k, v = key, value
    for step in range(ring.size):
        last = step == ring.size - 1
        if not last:  # the next block's transfer overlaps this block's math
            works, bufs = ring.post([k, v, kb])
        scores = torch.einsum("bqhd,bkhd->bhqk", query, k).to(torch.float32) * scale + kb
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        denom = denom * correction + p.sum(dim=-1)
        acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v.to(torch.float32))
        row_max = new_max
        if not last:
            ring.wait(works)
            k, v, kb = bufs
    out = acc / torch.clamp_min(denom.transpose(1, 2)[..., None], 1e-30)
    # a query row whose keys are masked in every block never leaves the
    # mask floor; return zeros instead of a uniform average over padding
    alive = row_max > neg * 0.5  # [B, H, T_q]
    out = torch.where(alive.transpose(1, 2)[..., None], out, torch.zeros((), device=out.device))
    lse = row_max + torch.log(torch.clamp_min(denom, 1e-30))
    return out, lse, alive


def _backward(grad_out, query, key, value, kb, out, lse, alive, ring: _Ring):
    depth = query.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(depth, dtype=torch.float32)).item()
    q = query.to(torch.float32)
    do = grad_out.to(torch.float32) * alive.transpose(1, 2)[..., None]
    delta = (do * out).sum(dim=-1).transpose(1, 2)  # [B, H, T_q]
    dq = torch.zeros_like(q)
    k, v = key.to(torch.float32), value.to(torch.float32)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    live = alive[..., None]
    for step in range(ring.size):
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + kb
        p = torch.where(live, torch.exp(scores - lse[..., None]), torch.zeros((), device=q.device))
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
        if ring.size > 1:
            # the block and its gradients move on together; after the last
            # block only the gradients rotate, which brings them home
            last = step == ring.size - 1
            works, bufs = ring.post([dk, dv] if last else [k, v, kb, dk, dv])
            ring.wait(works)
            if last:
                dk, dv = bufs
            else:
                k, v, kb, dk, dv = bufs
    return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype)


class RingAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, value, kb, group):
        ring = _Ring(group)
        out, lse, alive = _forward(query, key, value, kb, ring)
        ctx.ring = ring
        ctx.save_for_backward(query, key, value, kb, out, lse, alive)
        return out.to(query.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        query, key, value, kb, out, lse, alive = ctx.saved_tensors
        dq, dk, dv = _backward(grad_out, query, key, value, kb, out, lse, alive, ctx.ring)
        return dq, dk, dv, None, None


def ring_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    key_bias: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Exact attention with the sequence axis sharded over ``group``.

    Per-rank shapes: query/key/value [B, T_local, H, Dh]; ``key_mask``
    [B, T_local] marks real keys (1) and padding (0); or pass
    ``key_bias``, an additive bias broadcastable to [B, 1, 1, T_local].
    Returns this rank's query block's output [B, T_local, H, Dh] in the
    query dtype.  ``group`` None is a ring of one (this rank alone)."""
    kb = _key_bias(key, key_mask, key_bias)
    return RingAttentionFunction.apply(query, key, value, kb, group)


def make_ring_attention(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """``fn(q, k, v, mask)`` over this rank's sequence slice of each, the
    ring over ``mesh[axis_name]``."""
    group = mesh[axis_name]

    def fn(q, k, v, mask=None):
        return ring_attention(q, k, v, key_mask=mask, group=group)

    return fn


def encode_sequence_parallel(
    model,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
) -> torch.Tensor:
    """Run a ``BertEncoder`` built with ``attention_impl="ring"`` over this
    rank's slice of the sequence.  Every rank passes the whole [B, T]
    batch; everything but attention is position-wise, so each rank encodes
    its slice with its global position ids and only attention
    communicates.  Inference (no grad); returns this rank's [B, T/n, H]
    slice of the hidden states (rank order along ``axis_name``)."""
    if model.config.attention_impl != "ring":
        raise ValueError(
            "sequence-parallel encoding needs attention_impl='ring' "
            f"(got {model.config.attention_impl!r})"
        )
    b, t = input_ids.shape
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    if t % n != 0:
        raise ValueError(f"sequence length {t} not divisible by {axis_name}={n}")
    if t > model.config.max_position_embeddings:
        # the encoder's own guard sees position ids and skips its check
        raise ValueError(
            f"sequence length {t} exceeds max_position_embeddings="
            f"{model.config.max_position_embeddings}"
        )
    per = t // n
    cut = slice(i * per, (i + 1) * per)
    position_ids = torch.arange(t, device=input_ids.device)[None, :].expand(b, t)
    with torch.no_grad(), ring_group(mesh[axis_name]):
        return model(input_ids[:, cut], attention_mask[:, cut], position_ids=position_ids[:, cut])

