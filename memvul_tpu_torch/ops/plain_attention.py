"""The plain ("xla") attention formulation as one hand-written CUDA kernel.

``csrc/plain_attn.cu`` computes :func:`.attention.xla_attention`'s
formulation with its rounding points (bf16 scores, scaled and biased in
bf16, an f32 softmax normalised before it is rounded, an f32 PV sum) and
never writes the scores or the weights to device memory.  It replaces no
TPU kernel: XLA fuses the JAX package's ``_xla_attention`` under ``jit``,
and eager PyTorch cannot.

:func:`kernel_takes` is the routing predicate of
:func:`.attention.dot_product_attention` with ``impl="xla"``: the kernel
takes bf16 CUDA tensors at head dim 64 and at most 512 keys, a bias that
is ``None`` or a bf16 key-only ``[B, 1, 1, Tk]``, no dropout and no
gradient.  Everything else runs the plain formulation, and
:data:`plain_on_card` counts the ``impl="xla"`` calls on CUDA tensors that
did.  :func:`plain_attention_cuda` launches the kernel and raises on
anything it does not take; :func:`launch_taken` is the router's, for a
call the predicate already took.  :data:`launches` counts the launches.
:func:`score_divisor` is the formulation's ``sqrt(depth)`` in the query
dtype, computed on the host, for both paths.  :func:`agreement` is the
check that holds the kernel to the plain formulation, for the card tests
and ``chip_smoke.py``.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from . import _kernels

# kernel launches, and calls on CUDA tensors that the routing sent to the
# plain formulation, since the last reset (a caller sets them back to 0);
# incremented under the lock, since a fleet's replicas run from several
# threads
launches = 0
plain_on_card = 0
_lock = threading.Lock()

HEAD_DIM = 64
MAX_KEYS = 512  # a work item's bf16 scores fit in shared memory up to here


@functools.lru_cache(maxsize=None)
def score_divisor(depth: int, dtype: torch.dtype) -> float:
    """``sqrt(depth)`` rounded to ``dtype``, as the formulation divides the
    scores by it: the same bits as ``torch.sqrt(torch.tensor(depth,
    dtype))``, computed once on the host."""
    return float(torch.sqrt(torch.tensor(depth, dtype=dtype)))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def refusal(query, key, value, bias=None, dropout_rate: float = 0.0) -> Optional[str]:
    """Why the kernel does not compute this call, or None when it does:
    it takes bf16 q/k/v ``[B, T, H, 64]`` (k and v of one shape) with
    ``Tk`` at most 512, a bias that is ``None`` or bf16 key-only ``[B or 1,
    1, 1, Tk]``, no dropout, no gradient, and CUDA tensors on one device."""
    tensors = (query, key, value) + (() if bias is None else (bias,))
    if any(t.dtype != torch.bfloat16 for t in tensors):
        return f"dtypes {[str(t.dtype) for t in tensors]}, not bf16"
    if query.ndim != 4 or key.ndim != 4 or key.shape != value.shape:
        return (f"q/k/v {tuple(query.shape)}, {tuple(key.shape)}, {tuple(value.shape)} "
                "are not [B, T, H, D] with k and v alike")
    b, _, h, d = query.shape
    t_k = key.shape[1]
    if key.shape[0] != b or key.shape[2] != h or key.shape[3] != d or t_k < 1:
        return f"q {tuple(query.shape)} and k/v {tuple(key.shape)} disagree"
    if d != HEAD_DIM:
        return f"head dim {d}, not {HEAD_DIM}"
    if t_k > MAX_KEYS:
        return f"{t_k} keys, more than {MAX_KEYS}"
    if bias is not None and not (
        bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1
        and bias.shape[3] == t_k and bias.shape[0] in (1, b)
    ):
        return f"bias {tuple(bias.shape)} is not key-only [B, 1, 1, Tk]"
    if dropout_rate != 0.0:
        return "attention dropout"
    if _needs_grad(*tensors):
        return "a gradient is needed (the kernel has no backward)"
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) != 1:
        return "not CUDA tensors on one device"
    return None


def kernel_takes(query, key, value, bias=None, dropout_rate: float = 0.0) -> bool:
    """The routing predicate of ``impl="xla"``: the kernel computes the
    call exactly when :func:`refusal` finds nothing."""
    return refusal(query, key, value, bias, dropout_rate) is None


def count_plain_on_card(query: torch.Tensor) -> None:
    """One ``impl="xla"`` call that the routing sent to the plain path,
    counted where it runs on the card."""
    global plain_on_card
    if query.device.type != "cuda":
        return
    with _lock:
        plain_on_card += 1


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA reads 16-byte rows: a 16-byte-aligned base and batch, position
    and head strides that are nonzero multiples of 8 elements."""
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(s > 0 and s % 8 == 0 for s in t.stride()[:3])
    )


def plain_attention_cuda(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel on bf16 ``[B, T, H, 64]`` CUDA tensors (at most
    512 keys) and a bias that is ``None`` or bf16 key-only ``[B, 1, 1,
    Tk]``; ``[B, Tq, H, 64]`` out.  Raises on anything it does not take,
    gradients included (it has no backward)."""
    reason = refusal(query, key, value, bias)
    if reason is not None:
        raise ValueError(f"plain_attention_cuda does not take this call: {reason}")
    return launch_taken(query, key, value, bias)


def launch_taken(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`plain_attention_cuda` without its check, for a call that
    :func:`kernel_takes` has taken."""
    global launches
    b, t_q, h, d = query.shape
    t_k = key.shape[1]
    query, key, value = (
        t if _tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
        for t in (query, key, value)
    )
    rows, bias_sb = None, 0
    if bias is not None:
        rows = bias[:, 0, 0, :]
        if rows.stride(-1) != 1:
            rows = rows.contiguous()
        bias_sb = rows.stride(0) if rows.shape[0] == b and b > 1 else 0
    out = torch.empty((b, t_q, h, d), dtype=query.dtype, device=query.device)
    lib = _kernels.library()
    code = lib.memvul_plain_attn_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(),
        b, h, t_q, t_k,
        *query.stride()[:3], *key.stride()[:3], *value.stride()[:3], *out.stride()[:3],
        # sqrt(64) in bf16 is 8: its reciprocal is exact, so the kernel's
        # product by it is the formulation's division
        bias_sb, 1.0 / score_divisor(d, query.dtype), _kernels.stream_handle(query),
    )
    _kernels.check("memvul_plain_attn_fwd", code)
    with _lock:
        launches += 1
    return out


# The kernel against the plain formulation: only the order of the f32 sums
# differs, which flips a bf16 rounding only where a sum lies within about
# 1e-7 of itself from a rounding tie (a few outputs in 1e4), so at least
# BITWISE_SHARE of the outputs carry the formulation's very bits, and a
# flip moves an output by at most MAX_ULPS bf16 ulps of the largest value
# it averages.  Ulps of the output itself would not do: an output that is
# a cancellation of larger terms moves by their size (PyTorch's own sums
# in another order put such outputs 10 ulps off theirs).  A shortcut that
# rounds differently (unnormalised weights, unrounded scores) changes far
# more than 1e-3 of the bits; a lost key tile moves outputs by many ulps.
BITWISE_SHARE = 0.999
MAX_ULPS = 2.0


def agreement(got: torch.Tensor, want: torch.Tensor, value: torch.Tensor) -> dict:
    """``got`` against the formulation's ``want``, both ``[B, Tq, H, D]``
    over ``value`` ``[B, Tk, H, D]``: the share of outputs with ``want``'s
    very bits, the largest error (absolute, and in bf16 ulps of the
    largest |value| the output averages), and ``ok``: whether ``got``
    passes as the formulation's."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    largest = value.float().abs().amax(dim=1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(largest)) - 7)
    stats = {
        "bitwise_share": (got == want).float().mean().item(),
        "max_abs_err": err.max().item(),
        "max_ulps": (err / ulp).max().item(),
        "finite": bool(torch.isfinite(got).all()),
    }
    stats["ok"] = (stats["finite"] and stats["bitwise_share"] >= BITWISE_SHARE
                   and stats["max_ulps"] <= MAX_ULPS)
    return stats
