"""Model archives — the ``model.tar.gz`` contract of the JAX package.

An archive is a tar.gz holding ``config.json`` (the resolved config),
``weights.msgpack`` (the flax param tree, in flax's msgpack format) and
either ``vocab.txt`` (a bert-style vocabulary) or ``tokenizer.json`` (a
wordpiece tokenizer file, or a TextCNN's ``{word: id}`` vocabulary, which
the ``word`` tokenizer reads through ``vocab_path``).
:func:`load_archive` deep-merges overrides onto the stored config and
rebuilds the model (on ``device``), its weights carried across by
:func:`~memvul_tpu_torch.models.convert.params_from_flax`, and the
tokenizer.  :func:`save_archive` writes the same format, so either
package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import io
import json
import tarfile
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Union

from . import _msgpack
from .config import loads_config, merge_overrides

ARCHIVE_NAME = "model.tar.gz"


@dataclasses.dataclass
class Archive:
    config: Dict[str, Any]
    model: Any
    params: Dict[str, Any]  # the flax-layout param tree as read
    tokenizer: Any


def save_archive(
    out_path: Union[str, Path],
    config: Dict[str, Any],
    params,
    tokenizer_file: Optional[Union[str, Path]] = None,
) -> Path:
    """Package config + a flax-layout param tree (numpy or torch leaves;
    bf16 tensors keep their dtype) + the tokenizer file into ``out_path``.
    Members are written at gzip level 1: random or trained float weights
    barely compress, and level 9 only costs time."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    members = {
        "config.json": json.dumps(config, indent=2).encode(),
        "weights.msgpack": _msgpack.packb(params),
    }
    if tokenizer_file is not None and Path(tokenizer_file).exists():
        name = "vocab.txt" if str(tokenizer_file).endswith(".txt") else "tokenizer.json"
        members[name] = Path(tokenizer_file).read_bytes()
    with tarfile.open(out_path, "w:gz", compresslevel=1) as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return out_path


def _read_members(archive_path: Path) -> Dict[str, bytes]:
    out = {}
    with tarfile.open(archive_path, "r:gz") as tar:
        for member in tar.getmembers():
            if member.isfile():
                out[Path(member.name).name] = tar.extractfile(member).read()
    return out


def _config_and_tokenizer(archive_path: Union[str, Path], overrides):
    """(members, the config with ``overrides`` merged, the tokenizer)."""
    from .build import build_tokenizer

    archive_path = Path(archive_path)
    if archive_path.is_dir():
        archive_path = archive_path / ARCHIVE_NAME
    members = _read_members(archive_path)
    config = json.loads(members["config.json"])
    if overrides:
        if isinstance(overrides, str):
            overrides = loads_config(overrides)
        config = merge_overrides(config, overrides)
    tok_cfg = dict(config.get("tokenizer") or {})
    with tempfile.TemporaryDirectory() as tmp:
        if "vocab.txt" in members:
            # the archived bert-style vocab wins over any path the stored
            # config mentions (which may not exist on this host)
            path = Path(tmp) / "vocab.txt"
            path.write_bytes(members["vocab.txt"])
            tok_cfg.pop("tokenizer_path", None)
            tok_cfg["vocab_path"] = str(path)
        elif "tokenizer.json" in members:
            path = Path(tmp) / "tokenizer.json"
            path.write_bytes(members["tokenizer.json"])
            # a word tokenizer's file is its {word: id} vocabulary, a
            # wordpiece one's a tokenizers-library file
            if tok_cfg.get("type") == "word":
                tok_cfg["vocab_path"] = str(path)
            else:
                tok_cfg["tokenizer_path"] = str(path)
                tok_cfg.pop("vocab_path", None)
        tokenizer = build_tokenizer(tok_cfg)
    return members, config, tokenizer


def load_archive_config(
    archive_path: Union[str, Path],
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
):
    """(config with ``overrides`` merged, tokenizer) of an archive, without
    building its model: what a supervisor that scores nothing itself needs."""
    _, config, tokenizer = _config_and_tokenizer(archive_path, overrides)
    return config, tokenizer


def load_archive(
    archive_path: Union[str, Path],
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    device: Union[str, "torch.device"] = "cuda",  # noqa: F821
) -> Archive:
    """Load an archive (or a serialization dir holding one), merging
    config ``overrides``; the model lands on ``device``."""
    from .build import build_model, resolve_device
    from .models.convert import params_from_flax

    device = resolve_device(device)
    members, config, tokenizer = _config_and_tokenizer(archive_path, overrides)
    model = build_model(config.get("model") or {}, tokenizer.vocab_size)
    params = _msgpack.unpackb(members["weights.msgpack"])
    model.load_state_dict(params_from_flax(params, getattr(model, "config", None)))
    model.to(device).eval()
    return Archive(config=config, model=model, params=params, tokenizer=tokenizer)
