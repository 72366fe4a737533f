"""The plain float32 reference of MemVul's Siamese matcher over the
LFM2-MoE encoder (LFM2-8B-A1B's ``lfm2_moe``).

A report and each anchor are cut by the benchmark's own WordPiece
(:mod:`.wordpiece`), framed and truncated at the configuration's
``max_length``, and encoded one sequence at a time at its real length, so no
padding and no mask enter.  The encoder follows the published layer
equations (``modeling_lfm2_moe.py``; the program's
``memvul_tpu_torch/models/lfm2_reference.py`` holds the same code, copied
here because the benchmark imports nothing of the program):

* a block is ``h = x + op(operator_norm(x))``, ``out = h +
  ffn(ffn_norm(h))``, RMSNorm ``w ⊙ x / sqrt(mean(x²) + eps)``;
* ``op`` is causal attention (``full_attention``: ``q = RoPE(RMSNorm(q_proj
  x))``, ``k = RoPE(RMSNorm(k_proj x))`` with the norms over the head dim,
  rotate-half RoPE at θ = ``rope_theta``, scale ``1/sqrt(head_dim)``,
  query head h on K/V head ``h // (H / Hkv)``, then ``out_proj``) or the
  gated short convolution (``conv``: ``[B, C, u] = chunk₃(in_proj x)``,
  ``c[t] = w₀·v[t−2] + w₁·v[t−1] + w₂·v[t]`` of ``v = B ⊙ u``, then
  ``out_proj(C ⊙ c)``);
* ``ffn`` is ``w2(silu(w1 x) ⊙ w3 x)`` in the first ``num_dense_layers``
  blocks and the experts in the rest: ``s = sigmoid(gate x)``, the
  ``num_experts_per_tok`` largest ``s + expert_bias``, weights ``s`` there
  over their sum + 1e-6, times ``routed_scaling_factor``;
* the final RMSNorm (``embedding_norm``) at the last token.

MemVul's departures: the report's embedding is that last token's state
(no language-model head, no pooler), then MemVul's ReLU header, and the
match of report ``u`` against anchor ``v`` is the pair classifier over
``[u, v, |u - v|]``; the answer is the softmax's first class per anchor.
Everything runs in float32 with TF32 off, the weights read in float32
whatever precision they are handed in; the logits alone are then written in
the configuration's precision (:func:`answers`), as the program's scorer
writes its own.  Near-ties in the router can pick another expert here
than in a bf16 program; the comparison's limit is set from readings that
hold such flips.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# kinds of parameter, which the weight generator scales differently
MATRIX, EMBEDDING, BIAS, LN_WEIGHT = "matrix", "embedding", "bias", "ln_weight"


def parameter_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan-in) of every parameter, named as the
    program's ``MemoryModel`` with an LFM2 encoder names them: the public
    model's names under ``model.``, the stacked experts ``experts.w13``
    ([w1; w3]) and ``experts.w2``, MemVul's ``header`` and ``pair_kernel``.

    The weight generator draws a matrix N(0, 1/fan-in).  Each residual
    branch's last projection (attention's and the conv's ``out_proj``, the
    dense ``w2``, ``experts.w2``) is given ``fan-in · 2·layers``, GPT-2's
    depth scaling, and the token embeddings fan-in 1 (N(0, 1): the residual
    stream starts at the RMSNorms' output scale).  Every branch then adds
    1/(2·layers) of the stream's variance, and the 48 gated branches of a
    random decoder stay near linear: a rounding made early is not grown
    into another answer by the end."""
    d, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // heads
    f, fe, e = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["num_experts"]
    depth = 2 * len(cfg["layer_types"])
    spec = [("model.embed_tokens.weight", (cfg["vocab_size"], d), EMBEDDING, 1)]

    def matrix(name: str, n_out: int, n_in: int, out: bool = False) -> None:
        spec.append((name, (n_out, n_in), MATRIX, n_in * depth if out else n_in))

    for i, kind in enumerate(cfg["layer_types"]):
        p = f"model.layers.{i}"
        if kind == "full_attention":
            matrix(f"{p}.self_attn.q_proj.weight", heads * dh, d)
            matrix(f"{p}.self_attn.k_proj.weight", kv * dh, d)
            matrix(f"{p}.self_attn.v_proj.weight", kv * dh, d)
            matrix(f"{p}.self_attn.out_proj.weight", d, heads * dh, out=True)
            spec.append((f"{p}.self_attn.q_layernorm.weight", (dh,), LN_WEIGHT, dh))
            spec.append((f"{p}.self_attn.k_layernorm.weight", (dh,), LN_WEIGHT, dh))
        else:
            matrix(f"{p}.conv.in_proj.weight", 3 * d, d)
            spec.append((f"{p}.conv.conv.weight", (d, 1, cfg["conv_L_cache"]), MATRIX,
                         cfg["conv_L_cache"]))
            matrix(f"{p}.conv.out_proj.weight", d, d, out=True)
        spec.append((f"{p}.operator_norm.weight", (d,), LN_WEIGHT, d))
        spec.append((f"{p}.ffn_norm.weight", (d,), LN_WEIGHT, d))
        if i < cfg["num_dense_layers"]:
            matrix(f"{p}.feed_forward.w1.weight", f, d)
            matrix(f"{p}.feed_forward.w3.weight", f, d)
            matrix(f"{p}.feed_forward.w2.weight", d, f, out=True)
        else:
            if cfg["use_expert_bias"]:
                spec.append((f"{p}.feed_forward.expert_bias", (e,), BIAS, d))
            matrix(f"{p}.feed_forward.gate.weight", e, d)
            spec.append((f"{p}.feed_forward.experts.w13", (e, 2 * fe, d), MATRIX, d))
            spec.append((f"{p}.feed_forward.experts.w2", (e, d, fe), MATRIX, fe * depth))
    spec.append(("model.embedding_norm.weight", (d,), LN_WEIGHT, d))
    hd = cfg["header_dim"]
    spec.append(("header.dense.weight", (hd, d), MATRIX, d))
    spec.append(("header.dense.bias", (hd,), BIAS, d))
    spec.append(("pair_kernel", (3 * hd, cfg["num_classes"]), MATRIX, 3 * hd))
    return spec


def _strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    t, _, dh = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device).float() / dh))
    angles = torch.outer(torch.arange(t, device=x.device).float(), inv_freq)
    cos = torch.cat([angles, angles], dim=-1).cos()[:, None, :]
    sin = torch.cat([angles, angles], dim=-1).sin()[:, None, :]
    half = dh // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def _attention(W, p: str, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // heads
    eps, theta = float(cfg["norm_eps"]), float(cfg["rope_theta"])
    t = x.shape[0]
    q = (x @ W[f"{p}.q_proj.weight"].T).view(t, heads, dh)
    k = (x @ W[f"{p}.k_proj.weight"].T).view(t, kv_heads, dh)
    v = (x @ W[f"{p}.v_proj.weight"].T).view(t, kv_heads, dh)
    q = _rope(_rms_norm(q, W[f"{p}.q_layernorm.weight"], eps), theta)
    k = _rope(_rms_norm(k, W[f"{p}.k_layernorm.weight"], eps), theta)
    ahead = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    out = torch.empty(t, heads, dh, device=x.device)
    group = heads // kv_heads
    for h in range(heads):
        scores = (q[:, h] @ k[:, h // group].T) / math.sqrt(dh)
        out[:, h] = torch.softmax(scores.masked_fill(ahead, float("-inf")), dim=-1) @ v[:, h // group]
    return out.reshape(t, heads * dh) @ W[f"{p}.out_proj.weight"].T


def _short_conv(W, p: str, x: torch.Tensor) -> torch.Tensor:
    gate_b, gate_c, u = (x @ W[f"{p}.in_proj.weight"].T).chunk(3, dim=-1)
    v = gate_b * u
    taps = W[f"{p}.conv.weight"][:, 0, :]
    width = taps.shape[1]
    padded = torch.cat([torch.zeros(width - 1, v.shape[1], device=v.device), v])
    conv = sum(taps[:, i] * padded[i : i + v.shape[0]] for i in range(width))
    return (gate_c * conv) @ W[f"{p}.out_proj.weight"].T


def _dense_ffn(W, p: str, x: torch.Tensor) -> torch.Tensor:
    return (_silu(x @ W[f"{p}.w1.weight"].T) * (x @ W[f"{p}.w3.weight"].T)) @ W[f"{p}.w2.weight"].T


def _experts(W, p: str, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    scores = torch.sigmoid(x @ W[f"{p}.gate.weight"].T)
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
            inner = _silu(rows @ w13[e, :f].T) * (rows @ w13[e, f:].T)
            out.index_add_(0, token, weights[token, slot, None] * (inner @ w2[e].T))
    return out


@torch.no_grad()
def embed(weights: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[int]) -> torch.Tensor:
    """One sequence's header output ``u`` [header_dim] in float32."""
    W = weights
    eps = float(cfg["norm_eps"])
    table = W["model.embed_tokens.weight"]
    x = table[torch.tensor(list(ids), dtype=torch.long, device=table.device)]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"model.layers.{i}"
        h = _rms_norm(x, W[f"{p}.operator_norm.weight"], eps)
        if kind == "full_attention":
            x = x + _attention(W, f"{p}.self_attn", h, cfg)
        else:
            x = x + _short_conv(W, f"{p}.conv", h)
        h = _rms_norm(x, W[f"{p}.ffn_norm.weight"], eps)
        if i < cfg["num_dense_layers"]:
            x = x + _dense_ffn(W, f"{p}.feed_forward", h)
        else:
            x = x + _experts(W, f"{p}.feed_forward", h, cfg)
    last = _rms_norm(x[-1], W["model.embedding_norm.weight"], eps)
    return torch.relu(last @ W["header.dense.weight"].T + W["header.dense.bias"])


@torch.no_grad()
def match(weights: Dict[str, torch.Tensor], u: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """The pair classifier's logits [A, C] of report ``u`` [D] against every
    anchor of ``bank`` [A, D]."""
    kernel = weights["pair_kernel"]
    d = u.shape[0]
    return u @ kernel[:d] + bank @ kernel[d : 2 * d] + (u[None, :] - bank).abs() @ kernel[2 * d :]


def logits(weights: Dict[str, torch.Tensor], cfg: Dict, reports: Sequence[Sequence[int]],
           anchors: Sequence[Sequence[int]]) -> np.ndarray:
    """``[len(reports), len(anchors), C]`` logits in float32 for token-id
    sequences that are already framed and truncated."""
    _strict_f32()
    weights = {k: v.float() for k, v in weights.items()}
    bank = torch.stack([embed(weights, cfg, ids) for ids in anchors])
    rows = [match(weights, embed(weights, cfg, ids), bank) for ids in reports]
    return torch.stack(rows).cpu().numpy()


def answers(logits_: np.ndarray, dtype: str) -> np.ndarray:
    """P(same) from logits written in ``dtype`` (the precision the
    configuration states for the scorer's output), the softmax in float64."""
    t = torch.from_numpy(np.asarray(logits_, dtype=np.float32)).to(getattr(torch, dtype))
    return torch.softmax(t.to(torch.float64), dim=-1)[..., 0].numpy()
