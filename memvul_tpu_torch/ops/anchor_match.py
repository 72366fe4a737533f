"""The anchor-bank match: its hand-written CUDA kernel and plain version.

``logits[b, a, c] = u[b]·W_u[:, c] + v[a]·W_v[:, c] + Σ_d |u[b, d] − v[a, d]|·W_d[d, c]``
for ``u [B, D]``, ``anchors [A, D]`` and the bias-free pair kernel
``[3D, C]`` — the decomposed ``[u, v, |u−v|]`` concat-linear that
``MemoryModel.match_anchors`` runs against the whole bank.

* :func:`fused_anchor_match` launches ``csrc/anchor_match.cu``, the Hopper
  port of the TPU kernel ``memvul_tpu/ops/pallas/anchor_match.py:
  fused_anchor_match``: the ``[B, A, D]`` abs-diff never reaches device
  memory.  It takes CUDA tensors only; :data:`launches` counts its
  launches.
* :func:`anchor_match_reference` is the plain PyTorch decomposition (two
  small matmuls plus one ``[B, A, D]`` einsum), the numerical reference
  the kernel is held against.
* :func:`anchor_match` is the dispatch the model calls: ``"auto"`` and
  ``"fused"`` send a CUDA tensor to the kernel and a CPU tensor to the
  plain version; ``"xla"`` (the JAX package's name for the plain
  decomposition) always takes the plain version.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _kernels

# kernel launches since the last reset (a caller sets it back to 0);
# incremented under the lock, since a fleet's replicas launch from
# several threads
launches = 0
_launches_lock = threading.Lock()

MAX_CLASSES = 4


def anchor_match_reference(
    u: torch.Tensor, anchors: torch.Tensor, kernel: torch.Tensor
) -> torch.Tensor:
    """[B, D] × [A, D] × [3D, C] → [B, A, C] through the decomposed einsum
    (the JAX package's ``anchor_match_reference``)."""
    d = u.shape[-1]
    w_u, w_v, w_d = kernel[:d], kernel[d : 2 * d], kernel[2 * d :]
    term_u = u @ w_u  # [B, C]
    term_v = anchors @ w_v  # [A, C]
    diff = (u[:, None, :] - anchors[None, :, :]).abs()  # [B, A, D]
    term_d = torch.einsum("bad,dc->bac", diff, w_d)
    return term_u[:, None, :] + term_v[None, :, :] + term_d


def _check_inputs(u, anchors, kernel) -> None:
    if u.ndim != 2 or anchors.ndim != 2 or kernel.ndim != 2:
        raise ValueError(
            f"expected u[B, D], anchors[A, D], kernel[3D, C]; got "
            f"{tuple(u.shape)}, {tuple(anchors.shape)}, {tuple(kernel.shape)}"
        )
    d = u.shape[1]
    if anchors.shape[1] != d or kernel.shape[0] != 3 * d:
        raise ValueError(
            f"dimension mismatch: u D={d}, anchors D={anchors.shape[1]}, "
            f"kernel rows={kernel.shape[0]} (need 3D={3 * d})"
        )


def fused_anchor_match(
    u: torch.Tensor, anchors: torch.Tensor, kernel: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: [B, D] × [A, D] × [3D, C] → [B, A, C] in the
    input dtype, accumulated in f32.  Raises on anything it does not take
    (a CPU tensor, mixed dtypes, a dtype other than f32/bf16, more than
    four classes, non-contiguous inputs)."""
    global launches
    _check_inputs(u, anchors, kernel)
    tensors = (u, anchors, kernel)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("fused_anchor_match takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_anchor_match: inputs on different devices")
    if u.dtype not in _kernels.DTYPE_CODES or any(t.dtype != u.dtype for t in tensors):
        raise TypeError(
            "fused_anchor_match takes f32 or bf16 inputs of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_anchor_match takes contiguous inputs")
    b, d = u.shape
    a, c = anchors.shape[0], kernel.shape[1]
    if c > MAX_CLASSES:
        raise ValueError(f"fused_anchor_match handles C <= {MAX_CLASSES}, got {c}")
    out = torch.empty((b, a, c), dtype=u.dtype, device=u.device)
    lib = _kernels.library()
    code = lib.memvul_anchor_match(
        u.data_ptr(), anchors.data_ptr(), kernel.data_ptr(), out.data_ptr(),
        b, a, d, c, _kernels.DTYPE_CODES[u.dtype], _kernels.stream_handle(u),
    )
    _kernels.check("memvul_anchor_match", code)
    with _launches_lock:
        launches += 1
    return out


def anchor_match(
    u: torch.Tensor,
    anchors: torch.Tensor,
    kernel: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Bank-match dispatch — the single entry point the model calls."""
    if impl not in (None, "auto", "fused", "xla"):
        raise ValueError(
            f"unknown anchor_match impl {impl!r} (want auto | fused | xla)"
        )
    if impl != "xla" and u.device.type == "cuda":
        return fused_anchor_match(u, anchors, kernel)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"anchor_match: unsupported device {u.device}")
    _check_inputs(u, anchors, kernel)
    return anchor_match_reference(u, anchors, kernel)
