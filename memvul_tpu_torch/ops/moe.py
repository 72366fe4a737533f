"""A sparse mixture-of-experts feed-forward layer (LFM2's) and its grouped
expert GEMM, K5.

:func:`moe_forward` computes, for every token slot ``x[s]`` of a padded
batch (padding slots are routed too, as the dense layers compute them):

* the router: ``sigmoid(x · gateᵀ)`` in f32 (the product of f32 copies),
  the top-k experts of the scores plus ``expert_bias``, and as weights the
  scores (without the bias) at those experts over their sum + 1e-6, times
  the scaling factor (:func:`route`);
* the dispatch: the ``(slot, j)`` pairs sorted by expert (a stable sort),
  each expert's first pair found by a search of the sorted ids, so the
  offsets ``[E + 1]`` stay on the device, and the slots' rows gathered
  into that order (:func:`dispatch`);
* the experts: ``w2ₑ(silu(w1ₑ x) ⊙ w3ₑ x)`` for each pair, two
  :func:`grouped_gemm` calls over the stacked ``w13 [E, 2F, D]`` (w1 on
  rows 0..F−1, w3 on F..2F−1) and ``w2 [E, D, F]``;
* the combine: each slot's k outputs gathered back through the inverse
  permutation and summed in f32 with their weights, in top-k order.

Nothing in it waits for the card (``torch.bincount`` would: it reads its
maximum on the host), and no atomics are used.  The spans ``lfm2.moe.route``, ``lfm2.moe.experts`` and
``lfm2.moe.combine`` carry the batch id of the launch around them;
:data:`pairs_routed` counts pairs, and :func:`expert_rows` returns each
expert's rows summed on the device since the last reset, read once.

:func:`grouped_gemm` launches ``csrc/grouped_gemm.cu`` (K5) for CUDA
tensors and its plain version, :func:`grouped_gemm_reference`, for CPU
tensors: one ``torch.matmul`` per expert over f32 copies (f32 sums of
exact bf16 products), the SwiGLU in f32, one rounding to bf16;
:func:`agreement` holds K5's output to it.  K5 replaces
no TPU kernel (the JAX package has no experts); its header says what
bounds it.  :data:`launches` counts its launches.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from ..telemetry import spans
from . import _kernels

# K5 launches and routed (slot, expert) pairs since the last reset (a
# caller sets them back to 0)
launches = 0
pairs_routed = 0
_lock = threading.Lock()
# per device: int64 [E] rows each expert computed since the last reset
_expert_rows: Dict[torch.device, torch.Tensor] = {}


def route(x: torch.Tensor, gate_weight: torch.Tensor, expert_bias: Optional[torch.Tensor],
          top_k: int, norm_topk_prob: bool = True,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts [S, k] int64, weights [S, k] f32) of each slot of ``x``
    [S, D]; the router runs in f32 (``expert_bias`` None: no bias)."""
    scores = torch.sigmoid(x.float() @ gate_weight.float().t())
    biased = scores if expert_bias is None else scores + expert_bias.float()
    selected = torch.topk(biased, top_k, dim=-1).indices
    weights = scores.gather(1, selected)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    return selected, weights * scaling


def dispatch(selected: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order [P], offsets int32 [E + 1]): the flat pair ids ``s·k + j``
    sorted by expert (ties in pair order), and each expert's first
    position in that order."""
    ids, order = torch.sort(selected.reshape(-1), stable=True)
    bounds = torch.arange(num_experts + 1, device=ids.device, dtype=ids.dtype)
    return order, torch.searchsorted(ids, bounds).to(torch.int32)


def _swiglu(acc: torch.Tensor, width: int) -> torch.Tensor:
    gate, up = acc[:, :width], acc[:, width:]
    return gate / (1.0 + torch.exp(-gate)) * up


def grouped_gemm_reference(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                           swiglu: bool) -> torch.Tensor:
    """The plain version of K5: rows ``offsets[e]:offsets[e + 1]`` of ``x``
    [P, K] against ``w[e]`` [N, K], f32 sums, with ``swiglu`` the gated
    product of columns j and N/2 + j, rounded once to ``x``'s dtype.  Rows
    past ``offsets[E]`` are zeros.  (It reads the offsets on the host.)"""
    n = w.shape[1]
    width = n // 2 if swiglu else n
    out = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    # the plain version runs where the offsets are host memory (the CPU's
    # forward) or in a card test, never on the card's scoring path
    bounds = offsets.tolist()  # lint: disable=MV201
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            acc = torch.matmul(x[lo:hi].float(), w[e].float().t())
            out[lo:hi] = (_swiglu(acc, width) if swiglu else acc).to(x.dtype)
    return out


# K5 keeps the plain version's rounding points (f32 sums of exact bf16
# products, the SwiGLU in f32, one rounding) and changes only how the f32
# sums are taken, which flips a bf16 rounding only where a sum lies near a
# tie.  On the tensor cores that is more often than another order on the
# CUDA cores (99.96–99.97% bit-equal at K = 2048): cuBLAS's own bf16 GEMM
# with f32 sums reads 99.875% at the w2 shape, as K5 does, and the SwiGLU
# multiplies two such sums (K5: 99.79%; H100 runs).  So at least
# BITWISE_SHARE of the outputs carry the plain version's bits, and none
# moves by more than MAX_ULPS bf16 ulps of the larger of its own magnitude
# and its row's RMS (the sums' error scales with the row's terms, not with
# a cancelled output).  A lost reduction slice or a row given to the wrong
# expert moves outputs by tens of ulps.
BITWISE_SHARE = 0.997
MAX_ULPS = 1.0


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """K5's output ``got`` held to its plain version's ``want`` ([P, N]):
    the bit-equal share, the largest error in bf16 ulps, and ``ok``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=1, keepdim=True).sqrt()
    scale = torch.maximum(want.abs(), rms).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    stats = {"bitwise_share": (got == want).float().mean().item(),
             "max_ulps": (err / ulp).max().item(),
             "finite": bool(torch.isfinite(got).all())}
    stats["ok"] = (stats["finite"] and stats["bitwise_share"] >= BITWISE_SHARE
                   and stats["max_ulps"] <= MAX_ULPS)
    return stats



def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                      swiglu: bool) -> torch.Tensor:
    """Launch K5 on bf16 ``x`` [P, K] and ``w`` [E, N, K] (contiguous) with
    int32 ``offsets`` [E + 1] on the card; ``[P, N/2 or N]`` bf16 out, rows
    past ``offsets[E]`` unwritten.  Raises on anything it does not take."""
    global launches
    tensors = (x, w, offsets)
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("grouped_gemm_cuda takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or offsets.dtype != torch.int32:
        raise TypeError(f"grouped_gemm_cuda takes bf16 x and w and int32 offsets, got "
                        f"{x.dtype}, {w.dtype}, {offsets.dtype}")
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[2] or \
            tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, offsets "
                         f"{tuple(offsets.shape)} are not [P, K], [E, N, K], [E + 1]")
    if not (x.is_contiguous() and w.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("grouped_gemm_cuda takes contiguous tensors")
    p, k = x.shape
    e, n, _ = w.shape
    out = torch.empty((p, n // 2 if swiglu else n), dtype=x.dtype, device=x.device)
    if p == 0:
        return out
    code = _kernels.library().memvul_grouped_gemm(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), p, k, e, n,
        1 if swiglu else 0, _kernels.stream_handle(x))
    _kernels.check("memvul_grouped_gemm", code)
    with _lock:
        launches += 1
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 swiglu: bool = False) -> torch.Tensor:
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cuda":
        return grouped_gemm_cuda(x, w, offsets, swiglu)
    return grouped_gemm_reference(x, w, offsets, swiglu)


def _count(offsets: torch.Tensor, pairs: int) -> None:
    global pairs_routed
    rows = (offsets[1:] - offsets[:-1]).to(torch.int64)
    with _lock:
        pairs_routed += pairs
        total = _expert_rows.get(rows.device)
        if total is None or total.shape != rows.shape:
            _expert_rows[rows.device] = rows
        else:
            total.add_(rows)


def expert_rows(device) -> list:
    """Each expert's rows on ``device`` since the last reset (one read of
    the card), or [] if no layer ran there."""
    total = _expert_rows.get(torch.device(device))
    return [] if total is None else total.tolist()


def reset_counts() -> None:
    global launches, pairs_routed
    with _lock:
        launches = 0
        pairs_routed = 0
        _expert_rows.clear()


def moe_forward(x: torch.Tensor, gate_weight: torch.Tensor, expert_bias: Optional[torch.Tensor],
                w13: torch.Tensor, w2: torch.Tensor, top_k: int, norm_topk_prob: bool = True,
                scaling: float = 1.0) -> torch.Tensor:
    """The layer over ``x`` [S, D] (rows are token slots): ``[S, D]`` in
    ``x``'s dtype.  At S slots the pairs' buffers hold about 4·S·(2D + F)
    bf16 values (12 GB at 262144 slots, D = 2048)."""
    s, num_experts = x.shape[0], w13.shape[0]
    with spans.span("lfm2.moe.route"):
        selected, weights = route(x, gate_weight, expert_bias, top_k, norm_topk_prob, scaling)
        order, offsets = dispatch(selected, num_experts)
        rows = x.index_select(0, torch.div(order, top_k, rounding_mode="floor"))
        _count(offsets, s * top_k)
    with spans.span("lfm2.moe.experts"):
        hidden = grouped_gemm(rows, w13, offsets, swiglu=True)
        del rows
        y = grouped_gemm(hidden, w2, offsets)
        del hidden
    with spans.span("lfm2.moe.combine"):
        where = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device)).view(s, top_k)
        out = weights[:, :1] * y.index_select(0, where[:, 0]).float()
        for j in range(1, top_k):
            out += weights[:, j : j + 1] * y.index_select(0, where[:, j]).float()
        return out.to(x.dtype)

