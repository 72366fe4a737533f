"""Carry weights between the JAX package's layout and the port's.

:func:`params_from_flax` maps a flax param tree (numpy or torch leaves,
e.g. as :func:`memvul_tpu_torch.archive.load_archive` reads them) onto
the port's state dict, and :func:`flax_from_params` is its inverse (numpy
f32 leaves, which ``memvul_tpu.archive.load_archive`` reads).  Both know
the tree of each model by its top-level names:

* ``MemoryModel``: ``bert``, ``pooler``, ``header``, ``pair_kernel``;
* ``SingleModel``: ``bert``, ``pooler``, ``header``, ``classifier``;
* ``TextCNN``: ``embedding``, ``conv_{n}``, ``header``, ``classifier``;
* ``MLMModel``: ``bert``, ``transform``, ``transform_LayerNorm``,
  ``decoder_bias``.

Encoder keys are HF ``BertModel``'s under ``bert.``, the layout
``memvul_tpu.models.convert.export_bert_state_dict`` writes;
:func:`encoder_from_flax` and :func:`flax_encoder` convert the ``bert``
subtree alone (``encoder.msgpack``, the further-pretrained encoder).
Every tensor comes out f32.

Layout notes: flax ``Dense`` kernels are ``[in, out]`` (torch ``Linear``
stores ``[out, in]``); flax ``Conv`` kernels are ``[n, in, out]`` (torch
``Conv1d`` stores ``[out, in, n]``); the per-head ``DenseGeneral`` kernels
are ``[H, heads, Dh]`` for q/k/v and ``[heads, Dh, H]`` for the attention
output; with ``scan_layers`` the layers stack into leading-``[L]`` arrays
under ``encoder/layers/layer``, otherwise they sit at ``encoder/layer_{i}``
(:func:`encoder_layout` names which).  A ScalarMix encoder
(``last_layer_only=False``) carries ``bert/scalar_mix/{scalar_weights,
gamma}`` ↔ ``bert.scalar_mix.*``.

:func:`convert_bert_state_dict` takes an HF ``BertModel`` state dict (the
counterpart of ``memvul_tpu.models.convert.convert_bert_state_dict``):
the port's encoder already uses HF's keys, so it strips a ``bert.``
prefix, checks every key and shape against the geometry, and hands the
HF pooler back beside the encoder rather than loading it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .bert import BertConfig

# the two layer layouts of a flax encoder tree
STACKED, UNSTACKED = "stacked layers/layer (scan_layers=true)", "layer_i (scan_layers=false)"


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _t(x) -> torch.Tensor:
    return _f32(x).t().contiguous()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def encoder_layout(bert_tree: Dict) -> str:
    """The layer layout of a flax ``bert`` subtree: :data:`STACKED` or
    :data:`UNSTACKED`."""
    return STACKED if "layers" in bert_tree["encoder"] else UNSTACKED


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


def encoder_from_flax(bert: Dict, config: BertConfig) -> Dict[str, torch.Tensor]:
    """A flax ``bert`` subtree (either layer layout) → the port's
    ``BertEncoder`` state dict (HF ``BertModel`` keys, no prefix)."""
    h = config.hidden_size
    emb = bert["embeddings"]
    sd: Dict[str, torch.Tensor] = {
        "embeddings.word_embeddings.weight": _f32(emb["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _f32(emb["position_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight": _f32(emb["token_type_embeddings"]["embedding"]),
        "embeddings.LayerNorm.weight": _f32(emb["LayerNorm"]["scale"]),
        "embeddings.LayerNorm.bias": _f32(emb["LayerNorm"]["bias"]),
    }
    for i, layer in enumerate(_layers(bert["encoder"], config)):
        pre = f"encoder.layer.{i}."
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
    mix = bert.get("scalar_mix")
    if mix is not None:
        sd["scalar_mix.scalar_weights"] = _f32(mix["scalar_weights"])
        sd["scalar_mix.gamma"] = _f32(mix["gamma"]).reshape(())
    return sd


def flax_encoder(sd: Dict[str, torch.Tensor], config: BertConfig) -> Dict:
    """The port's ``BertEncoder`` state dict (no prefix) → the flax
    ``bert`` subtree (numpy f32), layers stacked under
    ``encoder/layers/layer`` when ``config.scan_layers``, else at
    ``encoder/layer_{i}``."""
    h, heads = config.hidden_size, config.num_heads
    dh = h // heads

    def dense(pre):
        return {"kernel": _np(sd[pre + ".weight"]).T.copy(), "bias": _np(sd[pre + ".bias"])}

    def ln(pre):
        return {"scale": _np(sd[pre + ".weight"]), "bias": _np(sd[pre + ".bias"])}

    def layer_tree(i):
        pre = f"encoder.layer.{i}."

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

    layers = [layer_tree(i) for i in range(config.num_layers)]
    if config.scan_layers:

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs, 0)

        encoder = {"layers": {"layer": stack(*layers)}}
    else:
        encoder = {f"layer_{i}": layers[i] for i in range(config.num_layers)}
    bert = {
        "embeddings": {
            "word_embeddings": {"embedding": _np(sd["embeddings.word_embeddings.weight"])},
            "position_embeddings": {"embedding": _np(sd["embeddings.position_embeddings.weight"])},
            "token_type_embeddings": {"embedding": _np(sd["embeddings.token_type_embeddings.weight"])},
            "LayerNorm": ln("embeddings.LayerNorm"),
        },
        "encoder": encoder,
    }
    if "scalar_mix.gamma" in sd:
        bert["scalar_mix"] = {
            "scalar_weights": _np(sd["scalar_mix.scalar_weights"]),
            "gamma": _np(sd["scalar_mix.gamma"]),
        }
    return bert


def _prefixed(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix``, with it stripped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def params_from_flax(params: Dict, config: Optional[BertConfig] = None) -> Dict[str, torch.Tensor]:
    """A flax ``{"params": ...}`` tree of any of the four models → the
    port's state dict (f32).  ``config`` is the encoder's (unused for
    TextCNN, which has none)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    if "lfm2" in p:  # an LFM2 model's state dict, by the port's names (lfm2_params)
        return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                for k, v in p["lfm2"].items()}
    if "bert" in p:
        sd.update({"bert." + k: v for k, v in encoder_from_flax(p["bert"], config).items()})
    for name in ("pooler", "header"):
        if name in p:
            dense = p[name]["dense"] if "dense" in p[name] else p[name]
            key = f"{name}.dense" if "dense" in p[name] else name
            sd[key + ".weight"] = _t(dense["kernel"])
            sd[key + ".bias"] = _f32(dense["bias"])
    if "pair_kernel" in p:
        sd["pair_kernel"] = _f32(p["pair_kernel"])
    if "classifier" in p:
        sd["classifier.weight"] = _t(p["classifier"]["kernel"])
    if "embedding" in p:
        sd["embedding.weight"] = _f32(p["embedding"]["embedding"])
    for name in (k for k in p if k.startswith("conv_")):
        sd[f"{name}.weight"] = _f32(p[name]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"{name}.bias"] = _f32(p[name]["bias"])
    if "transform" in p:
        sd["transform.weight"] = _t(p["transform"]["kernel"])
        sd["transform.bias"] = _f32(p["transform"]["bias"])
        sd["transform_LayerNorm.weight"] = _f32(p["transform_LayerNorm"]["scale"])
        sd["transform_LayerNorm.bias"] = _f32(p["transform_LayerNorm"]["bias"])
        sd["decoder_bias"] = _f32(p["decoder_bias"])
    return sd


def flax_from_params(
    state_dict: Dict[str, torch.Tensor], config: Optional[BertConfig] = None
) -> Dict:
    """The port's state dict of any of the four models → the flax
    ``{"params": ...}`` tree of numpy f32 arrays, the encoder's layers in
    the layout ``config.scan_layers`` names."""
    sd = state_dict

    def dense(pre):
        return {"kernel": _np(sd[pre + ".weight"]).T.copy(), "bias": _np(sd[pre + ".bias"])}

    params: Dict = {}
    encoder = _prefixed(sd, "bert.")
    if encoder:
        params["bert"] = flax_encoder(encoder, config)
    if "pooler.dense.weight" in sd:
        params["pooler"] = {"dense": dense("pooler.dense")}
    if "header.dense.weight" in sd:
        params["header"] = {"dense": dense("header.dense")}
    elif "header.weight" in sd:  # TextCNN's header is a bare Dense
        params["header"] = dense("header")
    if "pair_kernel" in sd:
        params["pair_kernel"] = _np(sd["pair_kernel"])
    if "classifier.weight" in sd:
        params["classifier"] = {"kernel": _np(sd["classifier.weight"]).T.copy()}
    if "embedding.weight" in sd:
        params["embedding"] = {"embedding": _np(sd["embedding.weight"])}
    for key in sorted(k for k in sd if k.startswith("conv_") and k.endswith(".weight")):
        name = key[: -len(".weight")]
        params[name] = {"kernel": _np(sd[key]).transpose(2, 1, 0).copy(),
                        "bias": _np(sd[name + ".bias"])}
    if "transform.weight" in sd:
        params["transform"] = dense("transform")
        params["transform_LayerNorm"] = {"scale": _np(sd["transform_LayerNorm.weight"]),
                                         "bias": _np(sd["transform_LayerNorm.bias"])}
        params["decoder_bias"] = _np(sd["decoder_bias"])
    return {"params": params}


def bert_encoder_shapes(config: BertConfig) -> Dict[str, Tuple[int, ...]]:
    """Key → shape of the port's ``BertEncoder`` state dict (HF
    ``BertModel``'s keys, no pooler) at ``config``'s geometry."""
    h, inter = config.hidden_size, config.intermediate_size
    shapes: Dict[str, Tuple[int, ...]] = {
        "embeddings.word_embeddings.weight": (config.vocab_size, h),
        "embeddings.position_embeddings.weight": (config.max_position_embeddings, h),
        "embeddings.token_type_embeddings.weight": (config.type_vocab_size, h),
        "embeddings.LayerNorm.weight": (h,),
        "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            shapes[pre + f"attention.self.{name}.weight"] = (h, h)
            shapes[pre + f"attention.self.{name}.bias"] = (h,)
        shapes[pre + "attention.output.dense.weight"] = (h, h)
        for name in ("attention.output.dense.bias", "attention.output.LayerNorm.weight",
                     "attention.output.LayerNorm.bias", "output.dense.bias",
                     "output.LayerNorm.weight", "output.LayerNorm.bias"):
            shapes[pre + name] = (h,)
        shapes[pre + "intermediate.dense.weight"] = (inter, h)
        shapes[pre + "intermediate.dense.bias"] = (inter,)
        shapes[pre + "output.dense.weight"] = (h, inter)
    return shapes


def convert_bert_state_dict(
    state_dict: Dict, config: BertConfig
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """HF ``BertModel`` state dict → (the port's ``BertEncoder`` state
    dict, the HF pooler's ``{"dense.weight", "dense.bias"}`` or None), f32.

    Keys may carry a leading ``bert.``; values may be tensors or numpy
    arrays.  Every key of the geometry must be present with its shape
    (else ``KeyError`` or ``ValueError`` naming the key), and a checkpoint
    deeper than ``config.num_layers`` raises rather than truncating.  The
    pooler is returned, not loaded (the memory model trains its own)."""
    sd = {(k[len("bert."):] if k.startswith("bert.") else k): v for k, v in state_dict.items()}
    depth = {int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer.")}
    if depth and max(depth) + 1 != config.num_layers:
        raise ValueError(
            f"checkpoint has {max(depth) + 1} encoder layers but config.num_layers="
            f"{config.num_layers}: a depth mismatch would truncate the converted model"
        )
    encoder: Dict[str, torch.Tensor] = {}
    for key, shape in bert_encoder_shapes(config).items():
        if key not in sd:
            raise KeyError(f"HF state dict lacks {key!r}")
        value = _f32(sd[key])
        if tuple(value.shape) != shape:
            raise ValueError(
                f"HF state dict {key!r} has shape {tuple(value.shape)}, the geometry wants {shape}"
            )
        encoder[key] = value
    pooler = None
    if "pooler.dense.weight" in sd:
        pooler = {"dense.weight": _f32(sd["pooler.dense.weight"]),
                  "dense.bias": _f32(sd["pooler.dense.bias"])}
    return encoder, pooler


def lfm2_params(model) -> Dict:
    """The archive tree of a ``MemoryModel`` with an LFM2 encoder: its
    state dict by the port's names, in the dtypes it holds (the JAX package
    has no such model, so no flax layout is owed)."""
    return {"params": {"lfm2": {k: v.detach().cpu() for k, v in model.state_dict().items()}}}
