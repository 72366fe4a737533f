"""Exact blockwise (flash) attention: its hand-written CUDA kernel and
plain version.

Layout is the JAX package's ``[B, T, H, Dh]`` throughout, with an additive
key-only bias (the encoder's padding mask, broadcastable to
``[B, 1, 1, Tk]``) applied in f32.

* :func:`flash_attention` launches ``csrc/flash_fwd.cu`` for CUDA tensors,
  the Hopper port of the TPU kernel ``memvul_tpu/ops/pallas/
  flash_kernel.py:flash_attention``: online softmax, the score matrix never
  in device memory.  It reads q/k/v through their strides, so views of a
  fused projection need no copy.  The entry point routes to one of two
  kernels: ``flash_fwd_wgmma_kernel`` for bf16 at head dim 64 on
  16-byte-aligned tensors whose strides are nonzero multiples of 8
  elements (the main path: TMA-fed tiles, wgmma, a producer warpgroup
  and two or three consumer warpgroups), and ``flash_fwd_kernel`` on the
  CUDA cores for f32, head dims 16 and 32, and unaligned views.
  :data:`launches` counts its launches.  A CPU tensor goes to the plain
  version.  Under a gradient (grad enabled, an input that requires it)
  the call goes through :class:`FlashAttentionFunction`, the counterpart
  of the TPU kernel's ``jax.custom_vjp``: the kernel's forward, and a
  backward that recomputes through the plain ``xla_attention``.
* :func:`flash_attention_reference` is the plain PyTorch version of the
  same arithmetic: scores in f32, the finite f32 minimum for masked keys
  (a fully masked row averages its values uniformly), p rounded to the
  value dtype before the PV product, the denominator clamped at 1e-30.
  It walks the queries in chunks so the ``[B, H, chunk, Tk]`` scores stay
  within ``max_score_bytes``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from . import _kernels

# kernel launches since the last reset (a caller sets it back to 0);
# incremented under the lock, since a fleet's replicas launch from
# several threads
launches = 0
_launches_lock = threading.Lock()

HEAD_DIMS = (16, 32, 64)


class UnsupportedBiasError(ValueError):
    """The bias has query or head structure; the kernel takes a key-only
    bias broadcastable to [B, 1, 1, Tk]."""


def key_bias(bias: Optional[torch.Tensor], b: int, t_k: int, device) -> torch.Tensor:
    """A bias broadcastable to [B, 1, 1, Tk] as f32 [B, Tk] (zeros for
    None); raises :class:`UnsupportedBiasError` for any other shape."""
    if bias is None:
        return torch.zeros((b, t_k), dtype=torch.float32, device=device)
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1 or bias.shape[3] != t_k:
        raise UnsupportedBiasError(
            "flash attention takes a key-only bias (broadcastable to "
            f"[B, 1, 1, Tk]); got shape {tuple(bias.shape)}"
        )
    out = bias[:, 0, 0, :].to(torch.float32)
    if out.shape[0] != b:
        out = out.expand(b, t_k)
    return out.contiguous()


def flash_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    max_score_bytes: int = 1 << 30,
) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: [B, Tq, H, D] in, [B, Tq, H, D]
    out in the query dtype."""
    b, t_q, h, d = query.shape
    t_k = key.shape[1]
    kb = key_bias(bias, b, t_k, query.device)[:, None, None, :]  # [B, 1, 1, Tk]
    scale = 1.0 / math.sqrt(d)
    k32 = key.to(torch.float32).permute(0, 2, 3, 1)  # [B, H, D, Tk]
    v32 = value.to(torch.float32).permute(0, 2, 1, 3)  # [B, H, Tk, D]
    out = torch.empty_like(query)
    chunk = max(1, min(t_q, max_score_bytes // max(1, 4 * b * h * t_k)))
    for start in range(0, t_q, chunk):
        q32 = query[:, start : start + chunk].to(torch.float32).permute(0, 2, 1, 3)
        s = torch.matmul(q32, k32) * scale + kb  # [B, H, c, Tk]
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        pv = torch.matmul(p.to(value.dtype).to(torch.float32), v32)
        out[:, start : start + chunk] = (pv / denom).permute(0, 2, 1, 3).to(query.dtype)
    return out


def _strides(t: torch.Tensor):
    sb, st, sh, sd = t.stride()
    if sd != 1:
        raise ValueError("flash attention needs a contiguous head dim (stride 1)")
    return sb, st, sh


def flash_attention_cuda(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_bias_f32: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel on [B, T, H, D] tensors and an f32 [B, Tk]
    key bias.  Raises on anything it does not take."""
    global launches
    tensors = (query, key, value, key_bias_f32)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention_cuda: inputs on different devices")
    if query.dtype not in _kernels.DTYPE_CODES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(
            "flash attention takes f32 or bf16 q/k/v of one dtype, got "
            f"{query.dtype}, {key.dtype}, {value.dtype}"
        )
    if query.ndim != 4 or key.shape != value.shape or key.ndim != 4:
        raise ValueError(
            f"expected q/k/v [B, T, H, D]; got {tuple(query.shape)}, "
            f"{tuple(key.shape)}, {tuple(value.shape)}"
        )
    b, t_q, h, d = query.shape
    t_k = key.shape[1]
    if key.shape[0] != b or key.shape[2] != h or key.shape[3] != d:
        raise ValueError(f"q {tuple(query.shape)} and k/v {tuple(key.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dims are {HEAD_DIMS}, got {d}")
    if t_k < 1:
        raise ValueError("flash attention needs at least one key")
    if (
        key_bias_f32.dtype != torch.float32
        or tuple(key_bias_f32.shape) != (b, t_k)
        or key_bias_f32.stride(1) != 1
    ):
        raise ValueError("key bias must be f32 [B, Tk] with contiguous rows")
    out = torch.empty((b, t_q, h, d), dtype=query.dtype, device=query.device)
    lib = _kernels.library()
    code = lib.memvul_flash_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        key_bias_f32.data_ptr(), out.data_ptr(),
        b, h, t_q, t_k, d,
        *_strides(query), *_strides(key), *_strides(value), *_strides(out),
        key_bias_f32.stride(0), 1.0 / math.sqrt(d), _kernels.DTYPE_CODES[query.dtype],
        _kernels.stream_handle(query),
    )
    _kernels.check("memvul_flash_fwd", code)
    with _launches_lock:
        launches += 1
    return out


def _reference_forward(query, key, value, key_bias_f32):
    """The plain version on an f32 [B, Tk] key bias (the CPU's forward)."""
    return flash_attention_reference(query, key, value, key_bias_f32[:, None, None, :])


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd, the port of the TPU kernel's
    ``jax.custom_vjp`` (``memvul_tpu/ops/pallas/flash_kernel.py:215-241``).
    The forward runs ``kernel`` (the CUDA kernel on the card, the plain
    version on the CPU) and saves q, k, v and the f32 key bias; the
    backward recomputes attention through the plain ``xla_attention``
    under autograd and returns its dq/dk/dv.  The bias gets no gradient.
    The backward holds the [B, H, Tq, Tk] scores, as the JAX package's
    XLA recompute does: the flash memory saving is forward-only."""

    @staticmethod
    def forward(ctx, query, key, value, key_bias_f32, kernel):
        ctx.save_for_backward(query, key, value, key_bias_f32)
        return kernel(query, key, value, key_bias_f32)

    @staticmethod
    def backward(ctx, grad_out):
        from .attention import xla_attention

        query, key, value, key_bias_f32 = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in (query, key, value))
            out = xla_attention(q, k, v, key_bias_f32[:, None, None, :])
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blockwise exact attention, [B, T, H, D] in and out: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors, each through
    :class:`FlashAttentionFunction` when a gradient is wanted."""
    if query.ndim != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(query.shape)}")
    if query.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {query.device}")
    kb = key_bias(bias, query.shape[0], key.shape[1], query.device)
    kernel = flash_attention_cuda if query.device.type == "cuda" else _reference_forward
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value)):
        return FlashAttentionFunction.apply(query, key, value, kb, kernel)
    return kernel(query, key, value, kb)
