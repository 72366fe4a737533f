"""ctypes binding for the native (C++) normalizer (the JAX package's
``data/native.py``, with the port's own copy of its source,
``native/normalizer.cpp``).

Design contract:

* the Python pass table in :mod:`.normalize` is the *specification*; the
  native library is an accelerator on the host, not a kernel on the card;
* the native path is enabled only after a runtime **parity self-check**
  — a battery of representative documents run through both
  implementations must agree byte-for-byte;
* every batch additionally cross-checks a **random ~1% sample** of its
  native outputs against the Python implementation; any mismatch
  disables the native path for the rest of the process and recomputes
  the batch in Python;
* any per-document native failure (NULL return) falls back to the Python
  implementation for that document.

The shared library is built with ``g++`` at first use into
``build/native/`` at the repository root, named by a hash of the source
and the flags (as ``ops/_kernels.py`` names the kernel library), so an
edited source never loads a stale build and a finished build is reused
by later processes.  ``MEMVUL_NATIVE=0`` disables the native path.

The win is the **GIL-free thread pool** in ``mv_normalize_batch``: on an
N-core host the corpus normalizes up to N× faster than Python threads
can.  Size cutoffs (std::regex recursion safety): single-document calls
fall back to Python above 16KB; batch calls run on 64MB-stack pool
threads and fall back above 256KB.  Non-ASCII documents always use
Python (the byte-oriented engine disagrees with unicode ``\\s``/``\\w``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import random
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .normalize import normalize_text

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "normalizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_state: Optional[str] = None  # None=unknown, "ok", "disabled"
_reason: Optional[str] = None  # human text: why disabled
_kind: Optional[str] = None  # structured: env_optout | load_failed |
#   parity_failed | runtime_parity_failed (diagnosis, not control flow)

# documents exercising every pass family; native must agree with Python on
# all of them before it is trusted
_SELF_CHECK_DOCS = [
    "",
    "plain words only here",
    "Fix CVE-2021-44228 and CWE-79 please",
    "see https://cve.mitre.org/cgi-bin/cvename.cgi?name=CVE-2021-44228 now",
    "download https://example.com/file.zip or https://example.com/page",
    "```\nTraceback error: something exploded\n```",
    "run `pip install foo` then `x = compute_thing()` done",
    "[readme](docs/readme.md) and [site](https://example.com)",
    "email me at someone@example.com or ping @username now",
    "path /usr/local/lib/python3.8/site-packages/foo.py crashed",
    "NullPointerException at line 404",
    "version 1.2.3-beta4 released on 2021-06-01",
    "camelCaseIdentifier and some_function() and obj.attr.method",
    "a-very-long-hyphenated-chain-of-words",
    "<div class=\"x\"> <<tags>> <b>bold</b>",
    "*emphasis* **strong** ## heading",
    "files: report.pdf data.csv script.sh archive.zip",
    "x" * 40 + " short",
    "multi\nline\ttext\rwith\\n escapes \\r\\n here",
    "yaml\nkey: value",
]


def library_path() -> Path:
    """Where the library of the current source and flags lives (built or
    not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libmemvul_native_{h.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    """Compile ``normalizer.cpp`` once per source hash; the path, or None
    when it cannot be built."""
    if not _SOURCE.exists():
        return None
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib_path.stem}_{os.getpid()}.so.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError) as e:
        logger.warning("native normalizer build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.mv_normalize.restype = ctypes.c_void_p
        lib.mv_normalize.argtypes = [ctypes.c_char_p]
        lib.mv_free.argtypes = [ctypes.c_void_p]
        lib.mv_normalize_batch.restype = None
        lib.mv_normalize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        lib.mv_abi_version.restype = ctypes.c_int
        if lib.mv_abi_version() != ABI_VERSION:
            logger.warning("native normalizer ABI mismatch — disabled")
            return None
    except (OSError, AttributeError) as e:
        # wrong-arch / corrupt / stale .so — fall back, never crash
        logger.warning("native normalizer unusable (%s) — disabled", e)
        return None
    return lib


def _native_one(lib: ctypes.CDLL, text: str) -> Optional[str]:
    if "\x00" in text:
        return None  # the C string boundary would truncate at the NUL
    ptr = lib.mv_normalize(text.encode("utf-8", errors="replace"))
    if not ptr:
        return None
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode("utf-8", "replace")
    finally:
        lib.mv_free(ptr)


def _self_check(lib: ctypes.CDLL) -> bool:
    for doc in _SELF_CHECK_DOCS:
        native = _native_one(lib, doc)
        expected = normalize_text(doc)
        if native != expected:
            logger.warning(
                "native normalizer parity self-check FAILED on %r: native=%r "
                "python=%r — native path disabled", doc[:60], native, expected,
            )
            return False
    return True


def get_native_normalizer() -> Optional[ctypes.CDLL]:
    """The parity-validated native library, or None."""
    global _lib, _state, _reason, _kind
    with _lock:
        if _state is not None:
            return _lib if _state == "ok" else None
        if os.environ.get("MEMVUL_NATIVE", "1") == "0":
            _state, _reason = "disabled", "MEMVUL_NATIVE=0 (env opt-out)"
            _kind = "env_optout"
            return None
        lib = _load()
        if lib is None:
            _state, _reason = "disabled", "library build/load failed"
            _kind = "load_failed"
            return None
        if not _self_check(lib):
            _state, _reason = "disabled", "parity self-check FAILED"
            _kind = "parity_failed"
            return None
        _lib = lib
        _state = "ok"
        logger.info("native normalizer enabled (parity self-check passed)")
        return _lib


def native_available() -> bool:
    return get_native_normalizer() is not None


def native_status() -> Dict[str, Optional[str]]:
    """Diagnostic state: ``{"state", "reason", "kind"}`` — ``kind`` is the
    STRUCTURED disable cause (env_optout | load_failed | parity_failed |
    runtime_parity_failed) so consumers branch on it, never on the
    human-readable ``reason`` text; both are None when enabled."""
    get_native_normalizer()
    return {"state": _state, "reason": _reason, "kind": _kind}


def normalize_batch(
    texts: Sequence[str],
    n_threads: Optional[int] = None,
    force_python: bool = False,
) -> List[str]:
    """Normalize many documents — native thread pool when available,
    Python fallback per document otherwise."""
    texts = list(texts)
    lib = None if force_python else get_native_normalizer()
    if lib is None or not texts:
        return [normalize_text(t) for t in texts]
    n = len(texts)
    n_threads = n_threads or min(32, os.cpu_count() or 1)
    # NUL bytes would truncate at the C-string boundary — those documents
    # are handled by the Python fallback regardless of the native result
    encoded = []
    fallback_indices = set()
    for i, t in enumerate(texts):
        if not isinstance(t, str) or "\x00" in t:
            fallback_indices.add(i)
            encoded.append(b"")
        else:
            encoded.append(t.encode("utf-8", errors="replace"))
    arr_in = (ctypes.c_char_p * n)(*encoded)
    arr_out = (ctypes.c_void_p * n)()
    lib.mv_normalize_batch(
        ctypes.cast(arr_in, ctypes.POINTER(ctypes.c_char_p)), n,
        ctypes.cast(arr_out, ctypes.POINTER(ctypes.c_void_p)), n_threads,
    )
    out: List[str] = []
    native_indices: List[int] = []
    for i, ptr in enumerate(arr_out):
        if ptr and i not in fallback_indices:
            try:
                out.append(
                    ctypes.cast(ptr, ctypes.c_char_p).value.decode("utf-8", "replace")
                )
            finally:
                lib.mv_free(ptr)
            native_indices.append(i)
        else:
            if ptr:
                lib.mv_free(ptr)
            # native refused (size/encoding limits) or the document needed
            # the NUL-safe path — authoritative Python fallback
            out.append(normalize_text(texts[i]))
    if native_indices and not _sampled_parity_ok(texts, out, native_indices):
        # drift between the native library and the Python specification —
        # disable native for the rest of the process and recompute this
        # batch authoritatively
        _disable_native(
            "sampled runtime parity check failed",
            kind="runtime_parity_failed",
        )
        return [normalize_text(t) for t in texts]
    return out


def _sampled_parity_ok(
    texts: Sequence[str], out: List[str], native_indices: List[int]
) -> bool:
    """Cross-check ~1% (min 1) of the batch's native outputs against the
    Python specification."""
    k = max(1, len(native_indices) // 100)
    sample = random.sample(native_indices, min(k, len(native_indices)))
    for i in sample:
        expected = normalize_text(texts[i])
        if out[i] != expected:
            logger.error(
                "native normalizer runtime parity FAILED on %r: native=%r "
                "python=%r", texts[i][:80], out[i][:120], expected[:120],
            )
            return False
    return True


def _disable_native(reason: str, kind: str = "runtime_parity_failed") -> None:
    global _lib, _state, _reason, _kind
    with _lock:
        _state = "disabled"
        _reason = reason
        _kind = kind
        _lib = None
    logger.warning("native normalizer disabled: %s", reason)
