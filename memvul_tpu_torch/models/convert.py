"""Carry weights between the JAX package's layout and the port's.

:func:`params_from_flax` maps a flax ``MemoryModel`` param tree (numpy or
torch leaves, e.g. as :func:`memvul_tpu_torch.archive.load_archive` reads
them) onto the port's :class:`~memvul_tpu_torch.models.memory.MemoryModel`
state dict.  Encoder keys are HF ``BertModel``'s under ``bert.``, the
layout ``memvul_tpu.models.convert.export_bert_state_dict`` writes; the
pooler, header and pair kernel follow.  Every tensor comes out f32.
:func:`flax_from_params` is its inverse: a port state dict → the flax
tree (numpy f32) that ``memvul_tpu.archive.load_archive`` reads, in the
layer layout that ``scan_layers`` in the config names.

Layout notes: flax ``Dense`` kernels are ``[in, out]`` (torch ``Linear``
stores ``[out, in]``); the per-head ``DenseGeneral`` kernels are
``[H, heads, Dh]`` for q/k/v and ``[heads, Dh, H]`` for the attention
output; with ``scan_layers`` the layers stack into leading-``[L]`` arrays
under ``encoder/layers/layer``, otherwise they sit at ``encoder/layer_{i}``.
A ScalarMix encoder (``last_layer_only=False``) carries
``bert/scalar_mix/{scalar_weights, gamma}`` ↔ ``bert.scalar_mix.*``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .bert import BertConfig


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _t(x) -> torch.Tensor:
    return _f32(x).t().contiguous()


def _layers(encoder: Dict, config: BertConfig) -> List[Dict]:
    """Per-layer param trees, from either layout."""
    if "layers" in encoder:
        stacked = encoder["layers"]["layer"]

        def pick(tree, i):
            if isinstance(tree, dict):
                return {k: pick(v, i) for k, v in tree.items()}
            return tree[i]

        depth = len(stacked["attention"]["query"]["kernel"])
        layers = [pick(stacked, i) for i in range(depth)]
    else:
        depth = sum(1 for k in encoder if k.startswith("layer_"))
        layers = [encoder[f"layer_{i}"] for i in range(depth)]
    if depth != config.num_layers:
        raise ValueError(
            f"param tree has {depth} encoder layers but config.num_layers="
            f"{config.num_layers}"
        )
    return layers


def params_from_flax(params: Dict, config: BertConfig) -> Dict[str, torch.Tensor]:
    """Flax ``{"params": {"bert", "pooler", "header", "pair_kernel"}}`` →
    the port's ``MemoryModel`` state dict (f32)."""
    p = params["params"] if "params" in params else params
    h = config.hidden_size
    emb = p["bert"]["embeddings"]
    sd: Dict[str, torch.Tensor] = {
        "bert.embeddings.word_embeddings.weight": _f32(emb["word_embeddings"]["embedding"]),
        "bert.embeddings.position_embeddings.weight": _f32(emb["position_embeddings"]["embedding"]),
        "bert.embeddings.token_type_embeddings.weight": _f32(emb["token_type_embeddings"]["embedding"]),
        "bert.embeddings.LayerNorm.weight": _f32(emb["LayerNorm"]["scale"]),
        "bert.embeddings.LayerNorm.bias": _f32(emb["LayerNorm"]["bias"]),
    }
    for i, layer in enumerate(_layers(p["bert"]["encoder"], config)):
        pre = f"bert.encoder.layer.{i}."
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            sd[pre + f"attention.self.{name}.weight"] = _t(_f32(attn[name]["kernel"]).reshape(h, h))
            sd[pre + f"attention.self.{name}.bias"] = _f32(attn[name]["bias"]).reshape(h)
        sd[pre + "attention.output.dense.weight"] = _t(_f32(attn["output"]["kernel"]).reshape(h, h))
        sd[pre + "attention.output.dense.bias"] = _f32(attn["output"]["bias"])
        sd[pre + "attention.output.LayerNorm.weight"] = _f32(attn["output_LayerNorm"]["scale"])
        sd[pre + "attention.output.LayerNorm.bias"] = _f32(attn["output_LayerNorm"]["bias"])
        sd[pre + "intermediate.dense.weight"] = _t(layer["intermediate"]["kernel"])
        sd[pre + "intermediate.dense.bias"] = _f32(layer["intermediate"]["bias"])
        sd[pre + "output.dense.weight"] = _t(layer["output"]["kernel"])
        sd[pre + "output.dense.bias"] = _f32(layer["output"]["bias"])
        sd[pre + "output.LayerNorm.weight"] = _f32(layer["output_LayerNorm"]["scale"])
        sd[pre + "output.LayerNorm.bias"] = _f32(layer["output_LayerNorm"]["bias"])
    mix = p["bert"].get("scalar_mix")
    if mix is not None:
        sd["bert.scalar_mix.scalar_weights"] = _f32(mix["scalar_weights"])
        sd["bert.scalar_mix.gamma"] = _f32(mix["gamma"]).reshape(())
    sd["pooler.dense.weight"] = _t(p["pooler"]["dense"]["kernel"])
    sd["pooler.dense.bias"] = _f32(p["pooler"]["dense"]["bias"])
    if "header" in p:
        sd["header.dense.weight"] = _t(p["header"]["dense"]["kernel"])
        sd["header.dense.bias"] = _f32(p["header"]["dense"]["bias"])
    sd["pair_kernel"] = _f32(p["pair_kernel"])
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def flax_from_params(state_dict: Dict[str, torch.Tensor], config: BertConfig) -> Dict:
    """The port's ``MemoryModel`` state dict → the flax ``{"params": ...}``
    tree of numpy f32 arrays, with the layers stacked under
    ``encoder/layers/layer`` when ``config.scan_layers``, else at
    ``encoder/layer_{i}``."""
    sd = state_dict
    h, heads = config.hidden_size, config.num_heads
    dh = h // heads

    def dense(pre):
        return {"kernel": _np(sd[pre + ".weight"]).T.copy(), "bias": _np(sd[pre + ".bias"])}

    def ln(pre):
        return {"scale": _np(sd[pre + ".weight"]), "bias": _np(sd[pre + ".bias"])}

    def layer(i):
        pre = f"bert.encoder.layer.{i}."

        def qkv(name):
            return {
                "kernel": _np(sd[pre + f"attention.self.{name}.weight"]).T.reshape(h, heads, dh).copy(),
                "bias": _np(sd[pre + f"attention.self.{name}.bias"]).reshape(heads, dh),
            }

        return {
            "attention": {
                "query": qkv("query"), "key": qkv("key"), "value": qkv("value"),
                "output": {
                    "kernel": _np(sd[pre + "attention.output.dense.weight"]).T.reshape(heads, dh, h).copy(),
                    "bias": _np(sd[pre + "attention.output.dense.bias"]),
                },
                "output_LayerNorm": ln(pre + "attention.output.LayerNorm"),
            },
            "intermediate": dense(pre + "intermediate.dense"),
            "output": dense(pre + "output.dense"),
            "output_LayerNorm": ln(pre + "output.LayerNorm"),
        }

    layers = [layer(i) for i in range(config.num_layers)]
    if config.scan_layers:

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs, 0)

        encoder = {"layers": {"layer": stack(*layers)}}
    else:
        encoder = {f"layer_{i}": layers[i] for i in range(config.num_layers)}
    emb = "bert.embeddings."
    params = {
        "bert": {
            "embeddings": {
                "word_embeddings": {"embedding": _np(sd[emb + "word_embeddings.weight"])},
                "position_embeddings": {"embedding": _np(sd[emb + "position_embeddings.weight"])},
                "token_type_embeddings": {"embedding": _np(sd[emb + "token_type_embeddings.weight"])},
                "LayerNorm": ln(emb + "LayerNorm"),
            },
            "encoder": encoder,
        },
        "pooler": {"dense": dense("pooler.dense")},
        "pair_kernel": _np(sd["pair_kernel"]),
    }
    if "bert.scalar_mix.gamma" in sd:
        params["bert"]["scalar_mix"] = {
            "scalar_weights": _np(sd["bert.scalar_mix.scalar_weights"]),
            "gamma": _np(sd["bert.scalar_mix.gamma"]),
        }
    if "header.dense.weight" in sd:
        params["header"] = {"dense": dense("header.dense")}
    return {"params": params}
