"""The plain float32 reference of the LFM2-MoE encoder (LFM2-8B-A1B's
``lfm2_moe``), as MemVul reads it: one sequence at a time, at its real
length, with no kernel, batching, padding or cache.

It imports nothing but ``torch``, and follows the published layer
equations (``modeling_lfm2_moe.py``) directly:

* a block is ``h = x + op(operator_norm(x))``, ``out = h +
  ffn(ffn_norm(h))``; RMSNorm is ``w ⊙ x / sqrt(mean(x²) + eps)``;
* ``op`` is attention (``full_attention``) or the gated short
  convolution (``conv``), by ``layer_types``.  Attention: ``q =
  RoPE(RMSNorm(q_proj x))``, ``k = RoPE(RMSNorm(k_proj x))`` (norms over
  the head dim), ``v = v_proj x``, softmax over keys ``j ≤ t`` at scale
  ``1/sqrt(head_dim)``, query head h reading K/V head ``h // (H / Hkv)``,
  then ``out_proj``; RoPE the rotate-half form with θ = ``rope_theta``.
  Short conv: ``[B, C, u] = chunk₃(in_proj x)``, ``v = B ⊙ u``, ``c[t] =
  w₀·v[t−2] + w₁·v[t−1] + w₂·v[t]`` (zeros before the sequence), then
  ``out_proj(C ⊙ c)``;
* ``ffn`` is ``w2(silu(w1 x) ⊙ w3 x)`` in the first ``num_dense_layers``
  blocks, and in the rest the experts: ``s = sigmoid(gate x)``, the
  ``num_experts_per_tok`` experts of largest ``s + expert_bias``, weights
  ``s`` there over their sum + 1e-6 (``norm_topk_prob``) times
  ``routed_scaling_factor``, and ``Σ weightₑ · w2ₑ(silu(w1ₑ x) ⊙ w3ₑ x)``;
* the final RMSNorm (``embedding_norm``), read at the last token.

Departures from the published model, all of them MemVul's: the embedding
is the last token's final-normed hidden state (there is no language-model
head), and :func:`embed` passes it through MemVul's ReLU header.  The
stacked expert weights are read as the program holds them
(``experts.w13`` = [w1; w3] along the output dim, ``experts.w2``).

Everything runs in float32 with TF32 off, whatever precision the weights
are handed in.  Weights are named as the port's ``MemoryModel`` names
them (``model.layers.{i}.self_attn.q_proj.weight``, ...); ``cfg`` holds
the published ``config.json`` keys.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` [T, H, Dh] rotated: position t, frequency i by ``t ·
    θ^(−2i/Dh)``, the first half of the dims paired with the second."""
    t, _, dh = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device).float() / dh))
    angles = torch.outer(torch.arange(t, device=x.device).float(), inv_freq)
    cos = torch.cat([angles, angles], dim=-1).cos()[:, None, :]
    sin = torch.cat([angles, angles], dim=-1).sin()[:, None, :]
    half = dh // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def attention(W: Dict[str, torch.Tensor], p: str, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // heads
    eps = float(cfg["norm_eps"])
    t = x.shape[0]
    q = (x @ W[f"{p}.q_proj.weight"].T).view(t, heads, dh)
    k = (x @ W[f"{p}.k_proj.weight"].T).view(t, kv_heads, dh)
    v = (x @ W[f"{p}.v_proj.weight"].T).view(t, kv_heads, dh)
    theta = float(cfg["rope_theta"])
    q = rope(rms_norm(q, W[f"{p}.q_layernorm.weight"], eps), theta)
    k = rope(rms_norm(k, W[f"{p}.k_layernorm.weight"], eps), theta)
    ahead = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    out = torch.empty(t, heads, dh, device=x.device)
    group = heads // kv_heads
    for h in range(heads):
        scores = (q[:, h] @ k[:, h // group].T) / math.sqrt(dh)
        probs = torch.softmax(scores.masked_fill(ahead, float("-inf")), dim=-1)
        out[:, h] = probs @ v[:, h // group]
    return out.reshape(t, heads * dh) @ W[f"{p}.out_proj.weight"].T


def short_conv(W: Dict[str, torch.Tensor], p: str, x: torch.Tensor) -> torch.Tensor:
    gate_b, gate_c, u = (x @ W[f"{p}.in_proj.weight"].T).chunk(3, dim=-1)
    v = gate_b * u
    taps = W[f"{p}.conv.weight"][:, 0, :]  # [D, L]
    width = taps.shape[1]
    padded = torch.cat([torch.zeros(width - 1, v.shape[1], device=v.device), v])
    conv = sum(taps[:, i] * padded[i : i + v.shape[0]] for i in range(width))
    return (gate_c * conv) @ W[f"{p}.out_proj.weight"].T


def dense_ffn(W: Dict[str, torch.Tensor], p: str, x: torch.Tensor) -> torch.Tensor:
    inner = silu(x @ W[f"{p}.w1.weight"].T) * (x @ W[f"{p}.w3.weight"].T)
    return inner @ W[f"{p}.w2.weight"].T


def experts(W: Dict[str, torch.Tensor], p: str, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    scores = torch.sigmoid(x @ W[f"{p}.gate.weight"].T)  # [T, E]
    bias = W.get(f"{p}.expert_bias")
    chosen = torch.topk(scores + (bias if bias is not None else 0.0), k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    weights = weights * float(cfg["routed_scaling_factor"])
    out = torch.zeros_like(x)
    w13, w2 = W[f"{p}.experts.w13"], W[f"{p}.experts.w2"]
    for e in range(w13.shape[0]):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if token.numel():
            rows = x[token]
            inner = silu(rows @ w13[e, :f].T) * (rows @ w13[e, f:].T)
            out.index_add_(0, token, weights[token, slot, None] * (inner @ w2[e].T))
    return out


@torch.no_grad()
def encode(weights: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[int]) -> torch.Tensor:
    """One sequence's final-normed hidden state at its last token [D], in
    float32."""
    W = weights
    eps = float(cfg["norm_eps"])
    dev = W["model.embed_tokens.weight"].device
    # the reference reads one sequence's ids from the host: it is no
    # program path, and waits for nothing it launched
    idx = torch.tensor(list(ids), dtype=torch.long, device=dev)  # lint: disable=MV201
    x = W["model.embed_tokens.weight"][idx]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"model.layers.{i}"
        h = rms_norm(x, W[f"{p}.operator_norm.weight"], eps)
        if kind == "full_attention":
            x = x + attention(W, f"{p}.self_attn", h, cfg)
        else:
            x = x + short_conv(W, f"{p}.conv", h)
        h = rms_norm(x, W[f"{p}.ffn_norm.weight"], eps)
        if i < cfg["num_dense_layers"]:
            x = x + dense_ffn(W, f"{p}.feed_forward", h)
        else:
            x = x + experts(W, f"{p}.feed_forward", h, cfg)
    return rms_norm(x[-1], W["model.embedding_norm.weight"], eps)


@torch.no_grad()
def embed(weights: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[int]) -> torch.Tensor:
    """MemVul's report embedding: ``relu(header(encode(ids)))`` [header_dim]."""
    u = encode(weights, cfg, ids)
    return torch.relu(u @ weights["header.dense.weight"].T + weights["header.dense.bias"])


def float_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights in float32, TF32 switched off for what reads them."""
    strict_f32()
    return {k: v.float() for k, v in weights.items()}
