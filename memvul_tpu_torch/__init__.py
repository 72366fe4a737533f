"""memvul_tpu_torch — the PyTorch/CUDA port of memvul_tpu for NVIDIA Hopper.

The JAX package ``memvul_tpu`` is the reference; this package mirrors its
module names, imports nothing of it, and runs its entry points on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .registry import Registrable  # noqa: E402,F401
