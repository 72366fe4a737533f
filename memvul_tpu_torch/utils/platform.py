"""Backend identification (the JAX package's ``utils/platform.py``, in its
card meanings).

* ``honor_platform_env`` re-asserts ``JAX_PLATFORMS`` before the first
  device op: here the device is an argument, resolved by
  :func:`resolve_device` (``build.resolve_device``: ``"cuda"`` unless the
  caller asks for the CPU; a CUDA device on a host without one raises).
* ``enable_compilation_cache`` points XLA at a persistent cache: the
  port's compiled artifacts are its kernel library, built by ``nvcc`` once
  per source hash into :data:`KERNEL_BUILD_DIR` and reused by later
  processes (:func:`kernel_library`).  PyTorch runs eagerly and the port
  uses no ``torch.compile``, so there is no other cache.
* ``is_tpu_backend`` becomes :func:`is_cuda_device`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from ..build import resolve_device  # noqa: F401 (the device resolution)
from ..ops._kernels import BUILD_DIR as KERNEL_BUILD_DIR


def is_cuda_device(device: Any = None) -> bool:
    """True when ``device`` (default: ``"cuda"``) is a CUDA device and a
    card is visible."""
    import torch

    device = torch.device("cuda" if device is None else device)
    return device.type == "cuda" and torch.cuda.is_available()


def kernel_library() -> Dict[str, Any]:
    """Where the kernel library of the current sources lives and whether
    it is built: ``{"dir", "library", "built", "entries"}`` (``entries``:
    libraries of any source hash in the directory)."""
    from ..ops import _kernels

    path = _kernels.library_path()
    return {
        "dir": str(KERNEL_BUILD_DIR),
        "library": path.name,
        "built": path.exists(),
        "entries": len(list(Path(KERNEL_BUILD_DIR).glob("libmemvul_kernels_*.so")))
        if Path(KERNEL_BUILD_DIR).exists() else 0,
    }
