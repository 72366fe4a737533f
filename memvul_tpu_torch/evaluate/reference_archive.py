"""Load a reference-format ``model.tar.gz`` (PyTorch/AllenNLP) into the
port's :class:`~memvul_tpu_torch.models.memory.MemoryModel` (the JAX
package's ``evaluate/reference_archive.py``).

The reference's training run leaves an archive holding ``config.json``
(the full train config) and ``weights.th`` (the torch state dict of
``model_memory``, reference: predict_memory.py:62-67).  This module maps
that state dict onto the port's so a checkpoint trained by the reference
pipeline scores here: the archive half of the F1-parity chain
(:mod:`memvul_tpu_torch.evaluate.parity`).

State-dict layout consumed (reference: model_memory.py:63-73):

* ``_text_field_embedder.token_embedder_tokens.transformer_model.*``: the
  HF BertModel, checked and renamed by
  :func:`memvul_tpu_torch.models.convert.convert_bert_state_dict` onto
  ``bert.*``;
* ``_bert_pooler.pooler.dense.*``: the fine-tuned tanh pooler (the
  transformer's own frozen pooler copy is ignored, as in the reference
  forward path, which only calls ``_bert_pooler``);
* ``_projector_single._linear_layers.0.*``: the ReLU projection header;
* ``_projector.weight``: the bias-free ``[2, 3D]`` pair classifier.

Layouts: the pooler and the header are ``nn.Linear`` on both sides
(``[out, in]``) and copy as they are; the port's ``pair_kernel`` is
``[3D, 2]``, so ``_projector.weight`` is transposed.
"""

from __future__ import annotations

import json
import tarfile
import tempfile
from pathlib import Path
from typing import Dict, Tuple, Union

import torch

from ..models.bert import BertConfig
from ..models.convert import _f32, _t, convert_bert_state_dict
from ..models.memory import MemoryModel

TRANSFORMER_PREFIX = "_text_field_embedder.token_embedder_tokens.transformer_model."
# the reference hardcodes FeedForward(dim, 1, [512], ReLU)
HEADER_DIM = 512


def convert_memory_state_dict(
    state_dict: Dict, config: BertConfig, use_header: bool = True
) -> Dict[str, torch.Tensor]:
    """Reference ``model_memory`` state dict → the port's ``MemoryModel``
    state dict (f32)."""
    transformer_sd = {
        k[len(TRANSFORMER_PREFIX):]: v for k, v in state_dict.items()
        if k.startswith(TRANSFORMER_PREFIX)
    }
    if not transformer_sd:
        raise KeyError(f"no keys under {TRANSFORMER_PREFIX!r}: not a model_memory state dict?")
    encoder, _ = convert_bert_state_dict(transformer_sd, config)
    sd = {"bert." + k: v for k, v in encoder.items()}
    sd["pooler.dense.weight"] = _f32(state_dict["_bert_pooler.pooler.dense.weight"])
    sd["pooler.dense.bias"] = _f32(state_dict["_bert_pooler.pooler.dense.bias"])
    sd["pair_kernel"] = _t(state_dict["_projector.weight"])
    if use_header:
        sd["header.dense.weight"] = _f32(state_dict["_projector_single._linear_layers.0.weight"])
        sd["header.dense.bias"] = _f32(state_dict["_projector_single._linear_layers.0.bias"])
    return sd


def load_reference_archive(
    archive_path: Union[str, Path],
    config: BertConfig,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[MemoryModel, Dict]:
    """Reference ``model.tar.gz`` → (model on ``device`` in eval mode,
    stored config).

    ``config`` supplies the encoder geometry (the reference config names an
    HF model rather than carrying dims).  The model hyperparameters the
    archive's config does carry (``use_header``, ``temperature``) are
    honoured.  Runs on the card unless the caller asks for the CPU."""
    from ..build import resolve_device

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with tarfile.open(archive_path, "r:gz") as tar:
            tar.extractall(tmp, filter="data")
        stored = json.loads((tmp / "config.json").read_text())
        state_dict = torch.load(tmp / "weights.th", map_location="cpu", weights_only=True)
    model_cfg = stored.get("model") or {}
    use_header = bool(model_cfg.get("use_header", True))
    model = MemoryModel(
        config, use_header=use_header, header_dim=HEADER_DIM,
        temperature=float(model_cfg.get("temperature", 0.1)),
    )
    model.load_state_dict(convert_memory_state_dict(state_dict, config, use_header=use_header))
    return model.to(device).eval(), stored
