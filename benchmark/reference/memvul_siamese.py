"""The plain reference of MemVul's Siamese matcher in float32.

A report and each anchor are cut by the benchmark's own WordPiece
(:mod:`.wordpiece`), framed and truncated at the configuration's
``max_length``, and encoded one sequence at a time at its real length, so no
padding and no mask enter: BERT (learned word, position and token-type
embeddings, LayerNorm; per layer multi-head self-attention with a softmax,
the output projection, a residual and LayerNorm, then a GELU (erf) feed
forward, a residual and LayerNorm), the pooler ``tanh(W·h_CLS + b)`` and the
header ``relu(W·p + b)``.  The match of a report ``u`` against anchor ``v``
is the pair classifier over ``[u, v, |u - v|]`` (a bias-free ``[3D, C]``
matrix), and the answer is the softmax's first class, P(same), per anchor.

Everything runs in float32 with TF32 off, the weights read in float32
whatever precision they are handed in.  The logits alone are then
written in the precision the configuration states for the scorer's output
(:func:`answers`; bfloat16 for a bf16 configuration, whose scorer writes
its logits in bf16): the exact result in the answer's format, so that the
rounding of the last step, which every correct bf16 scorer does, is no
gap, and what is left of a gap is what the computation before it lost.
Nothing here imports the program; the weights come from
:func:`parameter_spec` and the benchmark's seeded generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# kinds of parameter, which the weight generator scales differently
MATRIX, EMBEDDING, BIAS, LN_WEIGHT, LN_BIAS = "matrix", "embedding", "bias", "ln_weight", "ln_bias"


def parameter_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan-in) of every parameter, named as HF's
    ``BertModel`` under ``bert.`` with the scorer's ``pooler``, ``header``
    and ``pair_kernel``."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    d = cfg["header_dim"]
    spec = [
        ("bert.embeddings.word_embeddings.weight", (cfg["vocab_size"], h), EMBEDDING, h),
        ("bert.embeddings.position_embeddings.weight", (cfg["max_position_embeddings"], h),
         EMBEDDING, h),
        ("bert.embeddings.token_type_embeddings.weight", (cfg["type_vocab_size"], h), EMBEDDING, h),
        ("bert.embeddings.LayerNorm.weight", (h,), LN_WEIGHT, h),
        ("bert.embeddings.LayerNorm.bias", (h,), LN_BIAS, h),
    ]

    def dense(name: str, n_out: int, n_in: int) -> None:
        spec.append((f"{name}.weight", (n_out, n_in), MATRIX, n_in))
        spec.append((f"{name}.bias", (n_out,), BIAS, n_in))

    def norm(name: str) -> None:
        spec.append((f"{name}.weight", (h,), LN_WEIGHT, h))
        spec.append((f"{name}.bias", (h,), LN_BIAS, h))

    for i in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            dense(f"{p}.attention.self.{proj}", h, h)
        dense(f"{p}.attention.output.dense", h, h)
        norm(f"{p}.attention.output.LayerNorm")
        dense(f"{p}.intermediate.dense", f, h)
        dense(f"{p}.output.dense", h, f)
        norm(f"{p}.output.LayerNorm")
    dense("pooler.dense", h, h)
    dense("header.dense", d, h)
    spec.append(("pair_kernel", (3 * d, cfg["num_classes"]), MATRIX, 3 * d))
    return spec


def _strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


@torch.no_grad()
def embed(weights: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[int]) -> torch.Tensor:
    """One sequence's header output ``u`` [header_dim] in float32."""
    W = weights
    eps = float(cfg["layer_norm_eps"])
    heads = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // heads
    dev = W["pair_kernel"].device
    idx = torch.tensor(list(ids), dtype=torch.long, device=dev)
    n = idx.shape[0]
    x = (W["bert.embeddings.word_embeddings.weight"][idx]
         + W["bert.embeddings.position_embeddings.weight"][:n]
         + W["bert.embeddings.token_type_embeddings.weight"][0])
    x = _layer_norm(x, W["bert.embeddings.LayerNorm.weight"], W["bert.embeddings.LayerNorm.bias"], eps)

    def dense(name: str, v: torch.Tensor) -> torch.Tensor:
        return v @ W[f"{name}.weight"].T + W[f"{name}.bias"]

    for i in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        q, k, v = (dense(f"{p}.attention.self.{s}", x).reshape(n, heads, dh).transpose(0, 1)
                   for s in ("query", "key", "value"))
        probs = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(dh), dim=-1)
        ctx = (probs @ v).transpose(0, 1).reshape(n, heads * dh)
        x = _layer_norm(x + dense(f"{p}.attention.output.dense", ctx),
                        W[f"{p}.attention.output.LayerNorm.weight"],
                        W[f"{p}.attention.output.LayerNorm.bias"], eps)
        inner = F.gelu(dense(f"{p}.intermediate.dense", x))
        x = _layer_norm(x + dense(f"{p}.output.dense", inner),
                        W[f"{p}.output.LayerNorm.weight"], W[f"{p}.output.LayerNorm.bias"], eps)
    pooled = torch.tanh(dense("pooler.dense", x[0]))
    return torch.relu(dense("header.dense", pooled))


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


def probabilities(weights: Dict[str, torch.Tensor], cfg: Dict, reports: Sequence[Sequence[int]],
                  anchors: Sequence[Sequence[int]], dtype: str = "float32") -> np.ndarray:
    """``[len(reports), len(anchors)]`` P(same), the logits written in
    ``dtype`` before the softmax."""
    return answers(logits(weights, cfg, reports, anchors), dtype)
