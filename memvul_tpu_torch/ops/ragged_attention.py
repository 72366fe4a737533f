"""Segment-masked (ragged) exact attention for the packed serve path: its
hand-written CUDA kernel and plain version (the JAX package's
``ops/pallas/ragged_attention.py``).

Many requests are packed end to end into one ``[B, T]`` token row;
``segment_ids`` ``[B, T]`` int32 say which request each position belongs
to, 0 marking dead padding.  Query ``i`` sees key ``j`` iff
``seg[i] == seg[j] and seg[j] > 0``.  Dead rows (segment 0) see nothing
and average what they were given, a finite artifact that the row-starts
gather drops.

* :func:`ragged_flash_attention` launches ``csrc/ragged_fwd.cu`` for CUDA
  tensors, the Hopper port of the TPU kernel ``ragged_flash_attention``:
  online softmax, the ``[T, T]`` mask never in device memory, key tiles
  outside the query tile's segments skipped.  :data:`launches` counts its
  launches.  A CPU tensor goes to the plain version.
* :func:`pack_segments` builds, once per pack, the per-tile range table
  the kernel skips by; the encoder passes it to every layer.
  :func:`tile_ranges_reference` is the table's plain version, and
  :func:`visited_key_tiles` the kernel's choice of key tiles from it.
* :func:`ragged_flash_attention_reference` is the plain PyTorch version of
  the Pallas kernel's arithmetic: scores in f32, the finite f32 minimum for
  masked pairs, p rounded to the value dtype before the PV product, the
  denominator clamped at 1e-30.  It walks the queries in chunks so the
  ``[B, H, chunk, T]`` scores stay within ``max_score_bytes``.  (The JAX
  package's off-TPU fallback scales scores in the query dtype instead; the
  port follows the kernel.)
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import torch

from . import _kernels
from .flash_attention import HEAD_DIMS, _strides

# kernel launches since the last reset (a caller sets it back to 0);
# incremented under the lock, since a fleet's replicas launch from
# several threads
launches = 0
_launches_lock = threading.Lock()

# the kernel's range table has 64-position tiles and a visit mask of 2048
TILE = 64
MAX_TOKENS = 2048 * TILE


def segment_bias(segment_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, T] segment ids → additive bias [B, 1, Tq, Tk]: 0 where the
    query and key carry the same non-zero id, the dtype's finite minimum
    everywhere else (cross-request pairs and dead padding)."""
    q = segment_ids[:, :, None]
    k = segment_ids[:, None, :]
    allowed = (q == k) & (k > 0)
    zero = torch.zeros((), dtype=dtype, device=segment_ids.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=segment_ids.device)
    return torch.where(allowed[:, None, :, :], zero, neg)


def _check_shapes(query, key, value, segment_ids) -> None:
    if query.ndim != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(query.shape)}")
    if key.shape != query.shape or value.shape != query.shape:
        raise ValueError(
            "ragged attention is self-attention over one packed row: q, k, v "
            f"must share [B, T, H, D]; got {tuple(query.shape)}, "
            f"{tuple(key.shape)}, {tuple(value.shape)}"
        )
    if tuple(segment_ids.shape) != tuple(query.shape[:2]):
        raise ValueError(
            f"segment_ids {tuple(segment_ids.shape)} must match [B, T] "
            f"{tuple(query.shape[:2])}"
        )


def ragged_flash_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids: torch.Tensor,
    max_score_bytes: int = 1 << 30,
) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: [B, T, H, D] in, [B, T, H, D] out
    in the query dtype."""
    _check_shapes(query, key, value, segment_ids)
    b, t, h, d = query.shape
    scale = 1.0 / math.sqrt(d)
    neg = torch.finfo(torch.float32).min
    k32 = key.to(torch.float32).permute(0, 2, 3, 1)  # [B, H, D, T]
    v32 = value.to(torch.float32).permute(0, 2, 1, 3)  # [B, H, T, D]
    k_seg = segment_ids[:, None, None, :]  # [B, 1, 1, T]
    out = torch.empty_like(query)
    chunk = max(1, min(t, max_score_bytes // max(1, 4 * b * h * t)))
    for start in range(0, t, chunk):
        q32 = query[:, start : start + chunk].to(torch.float32).permute(0, 2, 1, 3)
        q_seg = segment_ids[:, start : start + chunk][:, None, :, None]  # [B, 1, c, 1]
        s = torch.matmul(q32, k32) * scale  # [B, H, c, T]
        s = torch.where((q_seg == k_seg) & (k_seg > 0), s, neg)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        pv = torch.matmul(p.to(value.dtype).to(torch.float32), v32)
        out[:, start : start + chunk] = (pv / denom).permute(0, 2, 1, 3).to(query.dtype)
    return out


def tile_ranges_reference(segment_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel library's tile-range pass: [B, T] ids →
    int32 [B, ceil(T / 64), 2], the (min, max) of the ids > 0 in each
    64-position tile, or (INT32_MAX, 0) where there is none."""
    b, t = segment_ids.shape
    n_tiles = -(-t // TILE)
    ids = torch.zeros((b, n_tiles * TILE), dtype=torch.int64, device=segment_ids.device)
    ids[:, :t] = segment_ids
    tiles = ids.view(b, n_tiles, TILE)
    live = tiles > 0
    big = torch.iinfo(torch.int32).max
    lo = torch.where(live, tiles, big).amin(dim=-1)
    hi = torch.where(live, tiles, 0).amax(dim=-1)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def visited_key_tiles(ranges: torch.Tensor, key_tile: int = TILE) -> torch.Tensor:
    """Which key tiles each query tile visits, as the kernel decides it from
    the range table: bool [B, n_query_tiles, n_key_tiles], key tiles of
    ``key_tile`` positions (a multiple of 64).  A key tile is visited iff
    the live range of one of its 64-position tiles meets the query tile's;
    an empty range meets nothing."""
    per = key_tile // TILE
    lo, hi = ranges[..., 0].long(), ranges[..., 1].long()
    meets = (lo[:, None, :] <= hi[:, :, None]) & (lo[:, :, None] <= hi[:, None, :])
    b, n, _ = meets.shape
    pad = -(-n // per) * per - n
    meets = torch.nn.functional.pad(meets, (0, pad))
    return meets.view(b, n, -1, per).any(dim=-1)


class PackedSegments(NamedTuple):
    """One pack's segment ids made ready for the attention of every layer
    (build it with :func:`pack_segments`): int32 ids with contiguous rows
    and, on the card, the live-id range of each 64-position tile that the
    kernel uses to skip key tiles.  The table is built once per pack, not
    once per layer."""

    ids: torch.Tensor
    tile_ranges: Optional[torch.Tensor] = None


def pack_segments(segment_ids) -> PackedSegments:
    """[B, T] segment ids → :class:`PackedSegments`; on a CUDA tensor this
    launches the kernel library's tile-range pass.  A ``PackedSegments``
    passes through."""
    if isinstance(segment_ids, PackedSegments):
        return segment_ids
    if segment_ids.device.type != "cuda":
        return PackedSegments(segment_ids)
    if segment_ids.ndim != 2:
        raise ValueError(f"segment_ids must be [B, T], got {tuple(segment_ids.shape)}")
    b, t = segment_ids.shape
    if t > MAX_TOKENS:
        raise ValueError(f"ragged kernel takes at most {MAX_TOKENS} positions, got {t}")
    ids = segment_ids.to(torch.int32).contiguous()
    ranges = torch.empty((b, -(-t // TILE), 2), dtype=torch.int32, device=ids.device)
    code = _kernels.library().memvul_ragged_tile_ranges(
        ids.data_ptr(), ranges.data_ptr(), b, t, ids.stride(0), _kernels.stream_handle(ids),
    )
    _kernels.check("memvul_ragged_tile_ranges", code)
    return PackedSegments(ids, ranges)


def ragged_flash_attention_cuda(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids,
) -> torch.Tensor:
    """Launch the CUDA kernel on [B, T, H, D] tensors and the pack's
    segment ids (a [B, T] tensor, or :func:`pack_segments` of one).
    Raises on anything it does not take."""
    global launches
    ids, ranges = pack_segments(segment_ids)
    tensors = (query, key, value, ids)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("ragged_flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ragged_flash_attention_cuda: inputs on different devices")
    if query.dtype not in _kernels.DTYPE_CODES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(
            "ragged attention takes f32 or bf16 q/k/v of one dtype, got "
            f"{query.dtype}, {key.dtype}, {value.dtype}"
        )
    _check_shapes(query, key, value, ids)
    b, t, h, d = query.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"ragged kernel head dims are {HEAD_DIMS}, got {d}")
    if ids.dtype != torch.int32 or (t > 1 and ids.stride(1) != 1):
        raise ValueError("segment_ids must be int32 [B, T] with contiguous rows")
    if ranges is None or tuple(ranges.shape) != (b, -(-t // TILE), 2) or ranges.device != ids.device:
        raise ValueError("the tile-range table does not match the segment ids: use pack_segments")
    out = torch.empty((b, t, h, d), dtype=query.dtype, device=query.device)
    code = _kernels.library().memvul_ragged_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        ids.data_ptr(), ranges.data_ptr(), out.data_ptr(),
        b, h, t, d,
        *_strides(query), *_strides(key), *_strides(value), *_strides(out),
        ids.stride(0), 1.0 / math.sqrt(d), _kernels.DTYPE_CODES[query.dtype],
        _kernels.stream_handle(query),
    )
    _kernels.check("memvul_ragged_fwd", code)
    with _launches_lock:
        launches += 1
    return out


def ragged_flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids,
) -> torch.Tensor:
    """Segment-masked exact attention, [B, T, H, D] in and out: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``segment_ids`` is a [B, T] tensor or :func:`pack_segments` of one.
    The kernel is forward-only, as the TPU kernel is: a CUDA input that
    needs a gradient raises instead of returning an output with none."""
    ids = segment_ids.ids if isinstance(segment_ids, PackedSegments) else segment_ids
    _check_shapes(query, key, value, ids)
    if query.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value)):
            raise RuntimeError(
                "ragged_flash_attention is forward-only (the packed serve path "
                "never trains); it has no gradient for q/k/v"
            )
        return ragged_flash_attention_cuda(query, key, value, segment_ids)
    if query.device.type != "cpu":
        raise ValueError(f"ragged_flash_attention: unsupported device {query.device}")
    return ragged_flash_attention_reference(query, key, value, ids)
