"""LFM2-MoE (``lfm2_moe``, LiquidAI's LFM2-8B-A1B) as a report encoder.

A decoder: token embeddings, then ``num_layers`` pre-norm blocks

    h = x + op(operator_norm(x));  out = h + ffn(ffn_norm(h))

where ``op`` is, by ``layer_types``, causal grouped-query attention
(``full_attention``) or a gated short convolution (``conv``), and ``ffn``
is a dense SwiGLU for the first ``num_dense_layers`` blocks and a sparse
mixture of experts for the rest; a final RMSNorm (``embedding_norm``).

* RMSNorm: ``w ⊙ x / sqrt(mean(x²) + eps)``, computed in f32 and rounded
  once to the model's dtype.
* Attention: ``q = RoPE(q_layernorm(q_proj x))``, ``k = RoPE(k_layernorm(
  k_proj x))``, ``v = v_proj x``; the QK-norms are RMSNorms over the head
  dim, RoPE the rotate-half form over all head dims (θ = ``rope_theta``),
  both in f32 with one rounding; causal softmax attention at scale
  ``1/sqrt(head_dim)``, query head h reading K/V head ``h // (H / Hkv)``
  (:func:`~memvul_tpu_torch.ops.attention.dot_product_attention` with
  ``causal=True``: K2 on the card; ``attention_impl`` takes only
  ``"flash"``); then ``out_proj``.
* Short conv: ``[B, C, u] = chunk₃(in_proj x)``, ``v = B ⊙ u``, the
  depthwise causal convolution ``c[t] = w₀·v[t−2] + w₁·v[t−1] + w₂·v[t]``
  (zeros before the first token; shifted products, no cuDNN), then
  ``out_proj(C ⊙ c)``; the elementwise chain in f32, rounded once.
* Dense FFN: ``w2(silu(w1 x) ⊙ w3 x)``, the gate in f32.
* MoE: :func:`~memvul_tpu_torch.ops.moe.moe_forward` (sigmoid router in
  f32 with ``expert_bias`` in the top-k, the experts through K5); the
  experts are stacked as ``experts.w13 [E, 2F, D]`` (w1 then w3) and
  ``experts.w2 [E, D, F]``.

The residual stream ``x``, ``h`` is held in f32: each block's output
(in the model's dtype) is added unrounded, and the norms read it as it is.
In bf16 its 48 roundings would be the largest part of the gap to the f32
reference, larger than an int8 projection's error.

No projection has a bias.  Parameters are held in ``config.dtype``
(bf16 for the published model: 8.34B parameters are 16.7 GB) and are made
where the caller's default device puts them (the meta device, then the
card, for the full model); :meth:`Lfm2Model.reset_parameters` draws them.
Names follow the public ``modeling_lfm2_moe.py`` under ``model.``.

As MemVul's encoder it is read at each report's last real token (the
model is causal, so only that position has read the whole report):
:meth:`Lfm2Model.pool_last`.  Batches are padded on the right, and with
causal attention and a causal convolution no padding reaches a real
token.  ``quant`` (``"int8_dynamic"`` / ``"int8"``) makes the attention,
conv and dense-FFN projections :class:`~memvul_tpu_torch.ops.quant.
QuantLinear`; the router and the experts stay in the model's dtype.

The packed (ragged, continuous) serving path, ring attention, tensor
parallelism and training refuse this encoder (:func:`refuse`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, mask_to_bias
from ..ops.moe import moe_forward
from ..ops.quant import QUANT_MODES, make_linear
from .bert import linear

ARCH = "lfm2_moe"

# token slots one encoder call runs at once (a batch's rows are split to
# fit), and those a dense FFN runs at once: at width 2048 and FFN 7168 the
# activations then stay near 15 GB beside the 16.7 GB of weights
CHUNK_TOKENS = 262144
FFN_CHUNK_TOKENS = 65536

# LFM2-8B-A1B's layer_types (its config.json): attention at 2, 6, 10, 14, 18, 21
LAYER_TYPES_8B = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))

# the published config.json keys read into Lfm2Config, and the field each fills
PUBLISHED_KEYS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "num_hidden_layers": "num_layers", "layer_types": "layer_types",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "intermediate_size", "moe_intermediate_size": "moe_intermediate_size",
    "num_experts": "num_experts", "num_experts_per_tok": "num_experts_per_tok",
    "num_dense_layers": "num_dense_layers", "use_expert_bias": "use_expert_bias",
    "norm_topk_prob": "norm_topk_prob", "routed_scaling_factor": "routed_scaling_factor",
    "conv_L_cache": "conv_L_cache", "conv_bias": "conv_bias", "rope_theta": "rope_theta",
    "norm_eps": "norm_eps", "max_position_embeddings": "max_position_embeddings",
}


@dataclasses.dataclass(frozen=True)
class Lfm2Config:
    vocab_size: int = 65536
    hidden_size: int = 2048
    num_layers: int = 24
    layer_types: Tuple[str, ...] = LAYER_TYPES_8B
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_experts: int = 32
    num_experts_per_tok: int = 4
    num_dense_layers: int = 2
    use_expert_bias: bool = True
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    conv_L_cache: int = 3
    conv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_position_embeddings: int = 128000
    dtype: Any = torch.bfloat16
    attention_impl: str = "flash"
    quant: Optional[str] = None
    anchor_match_impl: str = "auto"
    initializer_range: float = 0.02
    hidden_dropout: float = 0.0  # MemVul's header reads it; the encoder has none
    arch: str = ARCH

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "Lfm2Config":
        """An encoder section: the published ``config.json`` keys (the
        8B's values where absent) and the port's own (``dtype``,
        ``attention_impl``, ``quant``, ...)."""
        cfg = dict(cfg)
        cfg.pop("arch", None)
        cfg.pop("model_type", None)
        for key, field in PUBLISHED_KEYS.items():
            if key in cfg and key != field:
                cfg[field] = cfg.pop(key)
        if "layer_types" in cfg:
            cfg["layer_types"] = tuple(cfg["layer_types"])
        return cls(**cfg)

    @classmethod
    def tiny(cls, vocab_size: int = 512, **kw) -> "Lfm2Config":
        """Every layer kind at test size: conv, attention, conv, conv,
        attention; one dense layer, then 8 experts of which 2 are taken."""
        defaults = dict(
            vocab_size=vocab_size, hidden_size=64, num_layers=5,
            layer_types=("conv", "full_attention", "conv", "conv", "full_attention"),
            num_heads=4, num_kv_heads=2, intermediate_size=96, moe_intermediate_size=32,
            num_experts=8, num_experts_per_tok=2, num_dense_layers=1,
            max_position_embeddings=512, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    def replace(self, **kw) -> "Lfm2Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.quant!r}")
        if self.attention_impl != "flash":
            refuse(f"attention_impl {self.attention_impl!r} (it takes 'flash')")
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for {self.num_layers} layers")
        if set(self.layer_types) - {"conv", "full_attention"}:
            raise ValueError(f"unknown layer types in {self.layer_types}")
        if self.conv_bias:
            raise ValueError("LFM2's short convolution has no bias (conv_bias must be false)")
        if self.num_heads % self.num_kv_heads or self.hidden_size % self.num_heads:
            raise ValueError("heads must split the hidden size and group over the K/V heads")

    def encoder_flops(self, tokens: float, attn: float) -> float:
        """FLOPs of the encoder over ``tokens`` token slots whose causal
        attention covers ``attn`` (Σ n² over rows): every projection, the
        dense FFNs, the router, the k experts a slot takes, the conv's
        3-tap filter and gating, and attention's two products over half
        the square."""
        d, hd = self.hidden_size, self.head_dim
        kv = self.num_kv_heads * hd
        attn_layers = sum(t == "full_attention" for t in self.layer_types)
        conv_layers = self.num_layers - attn_layers
        moe_layers = self.num_layers - self.num_dense_layers
        per_token = attn_layers * 2.0 * d * (2 * d + 2 * kv)
        per_token += conv_layers * (2.0 * d * 4 * d + 8.0 * d)
        per_token += self.num_dense_layers * 2.0 * d * 3 * self.intermediate_size
        per_token += moe_layers * (2.0 * d * self.num_experts + self.num_experts_per_tok
                                   * 2.0 * d * 3 * self.moe_intermediate_size)
        return per_token * tokens + attn_layers * 2.0 * d * attn


def refuse(what: str) -> None:
    """The ValueError of a path that does not take this encoder."""
    raise ValueError(f"the LFM2 ({ARCH}) encoder has no {what}")


def is_lfm2(config) -> bool:
    return getattr(config, "arch", None) == ARCH


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype=None) -> torch.Tensor:
    """``weight ⊙ x / sqrt(mean(x²) + eps)`` over the last dim, in f32
    (PyTorch's fused ``rms_norm`` on an f32 copy), rounded once to
    ``dtype`` (f32 when None)."""
    out = F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps)
    return out if dtype is None else out.to(dtype)


def rope_tables(length: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, ...]:
    """(cos, sin) [T, head_dim] in f32: the default rotate-half RoPE's
    angles ``t · θ^(−2i/head_dim)``, each frequency on both halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim))
    angles = torch.outer(torch.arange(length, device=device).float(), inv_freq)
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, H, Dh] (f32) rotated by the [T, Dh] tables."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(size, dtype=dtype))

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, x.dtype if dtype is None else dtype)


class Lfm2Attention(nn.Module):
    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        self.config = c
        d, hd, dt = c.hidden_size, c.head_dim, c.dtype
        self.q_proj = make_linear(d, c.num_heads * hd, c.quant, bias=False, dtype=dt)
        self.k_proj = make_linear(d, c.num_kv_heads * hd, c.quant, bias=False, dtype=dt)
        self.v_proj = make_linear(d, c.num_kv_heads * hd, c.quant, bias=False, dtype=dt)
        self.out_proj = make_linear(c.num_heads * hd, d, c.quant, bias=False, dtype=dt)
        self.q_layernorm = RMSNorm(hd, c.norm_eps, dt)
        self.k_layernorm = RMSNorm(hd, c.norm_eps, dt)

    def forward(self, x, bias, rope):
        c = self.config
        b, t, _ = x.shape
        hd, dt = c.head_dim, c.dtype
        cos, sin = rope
        q = linear(x, self.q_proj, dt).view(b, t, c.num_heads, hd)
        k = linear(x, self.k_proj, dt).view(b, t, c.num_kv_heads, hd)
        v = linear(x, self.v_proj, dt).view(b, t, c.num_kv_heads, hd)
        q = apply_rope(rms_norm(q, self.q_layernorm.weight, c.norm_eps), cos, sin).to(dt)
        k = apply_rope(rms_norm(k, self.k_layernorm.weight, c.norm_eps), cos, sin).to(dt)
        attn = dot_product_attention(q, k, v, bias=bias, impl=c.attention_impl, causal=True)
        return linear(attn.reshape(b, t, -1), self.out_proj, dt)


class _DepthwiseWeight(nn.Module):
    """Holds the conv's ``weight`` [D, 1, L], named as ``nn.Conv1d``'s."""

    def __init__(self, channels: int, taps: int, dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps, dtype=dtype))


class Lfm2ShortConv(nn.Module):
    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        self.config = c
        d, dt = c.hidden_size, c.dtype
        self.in_proj = make_linear(d, 3 * d, c.quant, bias=False, dtype=dt)
        self.conv = _DepthwiseWeight(d, c.conv_L_cache, dt)
        self.out_proj = make_linear(d, d, c.quant, bias=False, dtype=dt)

    def forward(self, x, bias=None, rope=None):
        c = self.config
        gate_b, gate_c, u = linear(x, self.in_proj, c.dtype).chunk(3, dim=-1)
        v = gate_b.float() * u.float()
        # [L, D], each tap's row contiguous: tap L−1 reads v[t]
        taps = self.conv.weight[:, 0, :].t().float().contiguous()
        length = x.shape[1]
        conv = v * taps[-1]
        for shift in range(1, min(taps.shape[0], length)):
            conv[:, shift:] += v[:, :-shift] * taps[-1 - shift]
        del v
        return linear((gate_c.float() * conv).to(c.dtype), self.out_proj, c.dtype)


class Lfm2DenseFFN(nn.Module):
    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        self.config = c
        d, f, dt = c.hidden_size, c.intermediate_size, c.dtype
        self.w1 = make_linear(d, f, c.quant, bias=False, dtype=dt)
        self.w3 = make_linear(d, f, c.quant, bias=False, dtype=dt)
        self.w2 = make_linear(f, d, c.quant, bias=False, dtype=dt)

    def forward(self, x):
        dt = self.config.dtype
        flat = x.reshape(-1, x.shape[-1])
        out = torch.empty_like(flat)
        for i in range(0, flat.shape[0], FFN_CHUNK_TOKENS):
            part = flat[i : i + FFN_CHUNK_TOKENS]
            gate = F.silu(linear(part, self.w1, dt).float())
            gate.mul_(linear(part, self.w3, dt).float())
            out[i : i + FFN_CHUNK_TOKENS] = linear(gate.to(dt), self.w2, dt)
        return out.view_as(x)


class _Experts(nn.Module):
    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        e, d, f, dt = c.num_experts, c.hidden_size, c.moe_intermediate_size, c.dtype
        self.w13 = nn.Parameter(torch.empty(e, 2 * f, d, dtype=dt))
        self.w2 = nn.Parameter(torch.empty(e, d, f, dtype=dt))


class Lfm2MoE(nn.Module):
    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        self.config = c
        self.gate = nn.Linear(c.hidden_size, c.num_experts, bias=False, dtype=c.dtype)
        self.expert_bias = (nn.Parameter(torch.empty(c.num_experts, dtype=c.dtype))
                            if c.use_expert_bias else None)
        self.experts = _Experts(c)

    def forward(self, x):
        c = self.config
        b, t, d = x.shape
        out = moe_forward(x.reshape(b * t, d), self.gate.weight, self.expert_bias,
                          self.experts.w13, self.experts.w2, c.num_experts_per_tok,
                          c.norm_topk_prob, c.routed_scaling_factor)
        return out.view(b, t, d)


class Lfm2Layer(nn.Module):
    def __init__(self, c: Lfm2Config, index: int) -> None:
        super().__init__()
        self.config = c
        self.is_attention = c.layer_types[index] == "full_attention"
        if self.is_attention:
            self.self_attn = Lfm2Attention(c)
        else:
            self.conv = Lfm2ShortConv(c)
        self.operator_norm = RMSNorm(c.hidden_size, c.norm_eps, c.dtype)
        self.ffn_norm = RMSNorm(c.hidden_size, c.norm_eps, c.dtype)
        self.feed_forward = Lfm2DenseFFN(c) if index < c.num_dense_layers else Lfm2MoE(c)

    def forward(self, x, bias, rope):
        dt = self.config.dtype
        op = self.self_attn if self.is_attention else self.conv
        h = x + op(self.operator_norm(x, dt), bias, rope)
        return h + self.feed_forward(self.ffn_norm(h, dt))


class Lfm2Model(nn.Module):
    """token ids → hidden states [B, T, D] before the final norm, in f32."""

    def __init__(self, c: Lfm2Config) -> None:
        super().__init__()
        c.validate()
        self.config = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, dtype=c.dtype)
        self.layers = nn.ModuleList(Lfm2Layer(c, i) for i in range(c.num_layers))
        self.embedding_norm = RMSNorm(c.hidden_size, c.norm_eps, c.dtype)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Matrices, the conv taps and embeddings N(0, initializer_range²),
        norm scales 1, expert biases 0 (a no-op on the meta device)."""
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("expert_bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, attention_mask):
        c = self.config
        t = input_ids.shape[-1]
        if t > c.max_position_embeddings:
            raise ValueError(f"sequence length {t} exceeds max_position_embeddings="
                             f"{c.max_position_embeddings}")
        # the residual stream in f32: each block's output is added unrounded
        x = F.embedding(input_ids, self.embed_tokens.weight).float()
        bias = mask_to_bias(attention_mask, torch.float32)
        rope = rope_tables(t, c.head_dim, c.rope_theta, x.device)
        for layer in self.layers:
            x = layer(x, bias, rope)
        return x

    def pool_last(self, hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, D]: each row's last real token through the final norm (row
        0's first token for a row with no real token)."""
        last = (attention_mask.sum(dim=1) - 1).clamp_min(0)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        return self.embedding_norm(hidden[rows, last], self.config.dtype)

    def encode_last(self, input_ids, attention_mask) -> torch.Tensor:
        """[B, D]: :meth:`pool_last` of :meth:`forward`, the rows run
        :data:`CHUNK_TOKENS` slots at a time (rows are independent, so the
        chunks change no row's answer)."""
        rows = max(1, CHUNK_TOKENS // input_ids.shape[-1])
        return torch.cat([self.pool_last(self(input_ids[i : i + rows], attention_mask[i : i + rows]),
                                         attention_mask[i : i + rows])
                          for i in range(0, input_ids.shape[0], rows)])


def param_count(c: Lfm2Config) -> Tuple[int, int]:
    """(all parameters, those a token uses outside the embedding)."""
    d, hd = c.hidden_size, c.head_dim
    attn = 2 * d * c.num_heads * hd + 2 * d * c.num_kv_heads * hd + 2 * hd
    conv = 4 * d * d + d * c.conv_L_cache
    n_attn = sum(t == "full_attention" for t in c.layer_types)
    ops = n_attn * attn + (c.num_layers - n_attn) * conv + c.num_layers * 2 * d
    dense = c.num_dense_layers * 3 * d * c.intermediate_size
    moe_layers = c.num_layers - c.num_dense_layers
    expert = 3 * d * c.moe_intermediate_size
    router = d * c.num_experts + c.num_experts
    total = c.vocab_size * d + ops + dense + moe_layers * (router + c.num_experts * expert) + d
    active = ops + dense + moe_layers * (router + c.num_experts_per_tok * expert) + d
    return total, active
