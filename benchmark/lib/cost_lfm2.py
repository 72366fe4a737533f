"""Frozen arithmetic of the LFM2-MoE cell: the work of its reports and of
one launch of each of its kernels, from the configuration's published
sizes (``layer_types``, widths, experts), never from the program.

* :func:`useful_flops` — what reports of these real lengths need: every
  projection and dense FFN at the real length, the router and the k
  experts each token takes, the conv's taps and gates, causal attention
  over half the square (``2·H·Dh·n(n+1)`` a layer), MemVul's header and
  the anchor match;
* :func:`attention_launch` — one causal grouped attention launch (K2);
* :func:`moe_layer` — one MoE layer's two expert products (K5).

The card's peaks are :mod:`.cost`'s.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .cost import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S, roofline_seconds  # noqa: F401


def _layers(cfg: Dict) -> Tuple[int, int, int, int]:
    """(attention layers, conv layers, dense FFN layers, MoE layers)."""
    attn = sum(t == "full_attention" for t in cfg["layer_types"])
    dense = int(cfg["num_dense_layers"])
    n = int(cfg["num_hidden_layers"])
    return attn, n - attn, dense, n - dense


def token_flops(cfg: Dict) -> float:
    """FLOPs a token needs outside attention's products."""
    d = int(cfg["hidden_size"])
    heads, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    dh = d // heads
    attn, conv, dense, moe = _layers(cfg)
    flops = attn * 2.0 * d * (2 * heads * dh + 2 * kv * dh)
    flops += conv * (2.0 * d * 4 * d + 8.0 * d)
    flops += dense * 2.0 * d * 3 * int(cfg["intermediate_size"])
    flops += moe * (2.0 * d * int(cfg["num_experts"])
                    + int(cfg["num_experts_per_tok"]) * 2.0 * d * 3 * int(cfg["moe_intermediate_size"]))
    return flops


def useful_flops(cfg: Dict, lengths: Sequence[int], n_anchors: int) -> float:
    """The work of reports of these real lengths and their match against
    ``n_anchors`` anchors."""
    lengths = [int(n) for n in lengths]
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    attn, _, _, _ = _layers(cfg)
    flops = token_flops(cfg) * sum(lengths)
    flops += attn * 2.0 * d * float(sum(n * (n + 1) for n in lengths))
    out_dim = int(cfg["header_dim"])
    rows = len(lengths)
    flops += 2.0 * d * out_dim * rows
    if n_anchors:
        c = int(cfg["num_classes"])
        flops += rows * n_anchors * out_dim * (2.0 * c + 1.0) + 2.0 * out_dim * c * (rows + n_anchors)
    return flops


def attention_launch(cfg: Dict, batch: int, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal grouped attention launch over
    ``[batch, length]``: both products over the keys at or before each
    query, ``2·B·H·Dh·T(T+1)``; q and the output at H heads, k and v at Hkv
    heads, and the f32 key bias, each moved once (bf16)."""
    d, heads, kv = int(cfg["hidden_size"]), int(cfg["num_attention_heads"]), \
        int(cfg["num_key_value_heads"])
    dh = d // heads
    flops = 2.0 * batch * heads * dh * length * (length + 1)
    nbytes = 2.0 * batch * length * dh * (2 * heads + 2 * kv) + 4.0 * batch * length
    return flops, nbytes


def moe_layer(cfg: Dict, batch: int, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer's expert products over a ``[batch,
    length]`` batch, every slot routed to k experts (P = B·T·k pairs):
    ``2·P·3·D·F``; the experts' weights once, and the pairs' rows in and
    out of each of the two products once (bf16)."""
    d, f = int(cfg["hidden_size"]), int(cfg["moe_intermediate_size"])
    pairs = float(batch) * length * int(cfg["num_experts_per_tok"])
    flops = 2.0 * pairs * 3 * d * f
    nbytes = 2.0 * int(cfg["num_experts"]) * 3 * d * f + 2.0 * pairs * 2 * (d + f)
    return flops, nbytes
