"""Frozen arithmetic of the yardstick: the card's peaks, the work of a
scoring call and of one attention-kernel launch.

:func:`score_flops` is a copy of the program's ``telemetry/programs.py``
``score_cost`` FLOP count (encoder GEMMs over every processed token,
attention over each row's live tokens, the pooler, the header and the
anchor match), kept here so that a change to the program cannot move the
benchmark's ``mfu``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def score_flops(cfg: Dict, processed_tokens: int, live_lengths: Sequence[int], rows: int,
                n_anchors: int) -> float:
    """FLOPs of one encoder call over ``rows`` rows and their match against
    ``n_anchors`` anchors; ``cfg`` holds the configuration's sizes."""
    d = int(cfg["hidden_size"])
    f = int(cfg["intermediate_size"])
    layers = int(cfg["num_hidden_layers"])
    attn = float(sum(int(n) * int(n) for n in live_lengths))
    flops = layers * (2.0 * d * (4 * d + 2 * f) * float(processed_tokens) + 4.0 * d * attn)
    flops += 2.0 * d * d * rows  # pooler
    out_dim = int(cfg["header_dim"])
    flops += 2.0 * d * out_dim * rows
    if n_anchors:
        c = int(cfg["num_classes"])
        flops += rows * n_anchors * out_dim * (2.0 * c + 1.0) + 2.0 * out_dim * c * (rows + n_anchors)
    return flops


def useful_flops(cfg: Dict, lengths: Sequence[int], n_anchors: int) -> float:
    """The work that reports of these real lengths need: every GEMM and the
    attention at the real length, no padding."""
    lengths = [int(n) for n in lengths]
    return score_flops(cfg, sum(lengths), lengths, len(lengths), n_anchors)


def attention_launch(batch: int, length: int, heads: int, head_dim: int,
                     itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one dense attention launch over ``[batch, length,
    heads, head_dim]`` with an f32 key bias: both products over every query
    and key, and q, k, v, the output and the bias each moved once."""
    flops = 4.0 * batch * heads * length * length * head_dim
    nbytes = 4.0 * batch * length * heads * head_dim * itemsize + 4.0 * batch * length
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
