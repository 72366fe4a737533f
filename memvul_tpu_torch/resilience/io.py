"""Crash-safe file writes (the JAX package's ``resilience/io.py``)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

from . import faults


def atomic_write_text(path: Union[str, Path], text: str) -> Path:
    """Write ``text`` to ``path`` through a tmp file and ``os.replace``: a
    kill mid-write leaves the previous file (or none), never a torn one.
    The ``ckpt.write`` fault point sits in the torn-write window (tmp
    written, not yet renamed); an injected failure removes its tmp file."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        # this IS the committed helper: the tmp write precedes the
        # atomic os.replace commit below
        tmp.write_text(text)  # lint: disable=MV103
        faults.fault_point("ckpt.write")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return path
