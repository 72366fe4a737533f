"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an
object, one ``nvcc`` per source and all started together, and the objects
link into one shared library with a plain C interface that ``ctypes``
loads.  The sources include the shared headers ``csrc/*.cuh`` (device
helpers, and the Hopper pieces: mbarriers, TMA, wgmma).  No PyTorch header
is included, which keeps the build to seconds, and the library needs no
link against the driver: the TMA tensor-map encode is found at run time
through ``cudaGetDriverEntryPoint``.

The build runs at first use into ``build/kernels/`` at the repository
root; its wall time with the load is the ``kernels:<library>`` program of
the process's program registry (``telemetry/programs.py``) and, while the
process records spans, the ``kernels.load`` span.  The
library's name carries a hash of the sources, the headers and the flags,
so an edited kernel or header never loads a stale build, and a finished
build is reused by later processes.  There is no fallback: a
host without ``nvcc`` or a source that does not compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from ..telemetry import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the dtype argument of every entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of every exported kernel entry point (pointers and the
# stream as c_void_p, so ctypes never cuts a 64-bit address to 32 bits)
PROTOTYPES = {
    # u, v, w, out, B, A, D, C, dtype, stream
    "memvul_anchor_match": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, bias, out, B, H, Tq, Tk, D, Hkv, causal, 12 strides, bias_sb,
    # scale, dtype, stream
    "memvul_flash_fwd": [_P] * 5 + [_I] * 7 + [_L] * 13 + [_F, _I, _P],
    # segment_ids, ranges, B, T, seg_sb, stream
    "memvul_ragged_tile_ranges": [_P, _P, _I, _I, _L, _P],
    # q, k, v, segment_ids, ranges, out, B, H, T, D, 12 strides, seg_sb,
    # scale, dtype, stream
    "memvul_ragged_fwd": [_P] * 6 + [_I] * 4 + [_L] * 13 + [_F, _I, _P],
    # the wgmma flash kernel's dynamic shared memory per block, in bytes,
    # for 2 or 3 consumer warpgroups
    "memvul_flash_fwd_wgmma_smem_bytes": [_I],
    # q, k, v, bias (or null), out, B, H, Tq, Tk, 12 strides, bias_sb,
    # 1 / divisor, stream
    "memvul_plain_attn_fwd": [_P] * 5 + [_I] * 4 + [_L] * 13 + [_F, _P],
    # the plain attention kernel's dynamic shared memory per block at Tk keys
    "memvul_plain_attn_smem_bytes": [_I],
    # x, w, offsets, out, P, K, E, N, swiglu, stream
    "memvul_grouped_gemm": [_P] * 4 + [_L] + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what ptxas said in the last build (registers, spills, shared memory per
# kernel); read by chip_smoke.py
build_log: str = ""


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels build with the CUDA toolkit for sm_90a"
    )


def sources() -> list:
    """The translation units: each compiles to one object."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    """The headers the sources include; hashed, never compiled alone."""
    return sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources, headers and flags lives
    (built or not)."""
    return BUILD_DIR / f"libmemvul_kernels_{_digest(sources() + headers())}.so"


def build(force: bool = False) -> Path:
    """Compile every source in parallel and link them into one library;
    returns its path.  Reuses a finished build of the same sources."""
    global build_log
    srcs = sources()
    lib_path = library_path()
    digest = lib_path.stem.rsplit("_", 1)[1]
    if lib_path.exists() and not force:
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}_{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"libmemvul_kernels_{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, "-shared", *map(str, objects), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            # the build runs once per process, before the first launch: its
            # clock is not in any forward's launch stream
            t0 = spans.begin("kernels.load")
            try:
                path = build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in PROTOTYPES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.memvul_error_string.argtypes = [ctypes.c_int]
                lib.memvul_error_string.restype = ctypes.c_char_p
            finally:
                compile_s = (spans.end() - t0) / 1e9
            _lib = lib
            from ..telemetry.programs import get_program_registry

            get_program_registry().register(f"kernels:{path.stem}", scope="build",
                                            compile_s=compile_s)
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        text = library().memvul_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({text})")


def stream_handle(tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
