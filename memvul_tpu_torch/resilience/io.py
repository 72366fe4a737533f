"""Crash-safe file writes (the JAX package's ``resilience/io.py``)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union


def atomic_write_text(path: Union[str, Path], text: str) -> Path:
    """Write ``text`` to ``path`` through a tmp file and ``os.replace``: a
    kill mid-write leaves the previous file (or none), never a torn one."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        tmp.write_text(text)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return path
