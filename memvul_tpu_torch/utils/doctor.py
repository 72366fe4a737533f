"""Environment / artifact self-diagnosis (``python -m memvul_tpu_torch
doctor``; the JAX package's ``utils/doctor.py``).

One JSON report, the JAX package's sections:

* ``backend`` + ``mesh``: the device's presence, a tiny matmul and a
  cross-device sum — ALL device ops run in one child process under a
  timeout (a hung first CUDA call must not hang the doctor), killed with
  the bench's discipline (``bench._kill_process_group``).  ``mesh`` is the
  JAX package's probe: ``create_mesh({"data": n})`` over the n visible
  cards (one rank per card, :func:`mesh_probe`; a world of one on one
  card, or on the CPU), ``arange(n*4)`` sharded over it and summed;
  ``--skip-device`` skips the child, ``--device cpu`` probes the CPU;
* ``vocabulary``: whether the config's ``vocab_path`` exists (genuine
  vocabulary) or only the trained ``tokenizer_path`` (the fallback);
* ``data_artifacts``: the train/validation/anchor/CVE files the config
  names;
* ``native_normalizer``: the library builds, loads AND passes its parity
  self-check (``data/native.native_status``);
* ``compile_cache``: the kernel build directory (``build/kernels/``), and
  whether the library of the current sources' hash is built — the port's
  compiled artifacts, where the JAX package reports XLA's cache.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

_DEVICE_PROBE = """
import sys
import torch
device = sys.argv[1]
if device == "cuda":
    n = torch.cuda.device_count()
    if n == 0:
        sys.exit("RuntimeError: no CUDA device is visible (--device cpu probes the CPU)")
    devices = [torch.device(f"cuda:{i}") for i in range(n)]
else:
    n, devices = 1, [torch.device("cpu")]
x = torch.ones((64, 64), device=devices[0])
s = float((x @ x).sum())
print("DOCTOR_BACKEND", n, devices[0].type, s, flush=True)
if n == 1:
    from memvul_tpu_torch.utils.doctor import mesh_probe
    total = mesh_probe(device)
else:
    import tempfile
    from memvul_tpu_torch.parallel.launch import run_ranks
    with tempfile.TemporaryDirectory() as work:
        total = run_ranks("memvul_tpu_torch.utils.doctor:mesh_probe", n, work,
                          {"device": device}, timeout_s=float(sys.argv[2]))[0]
print("DOCTOR_MESH", n, total, float(sum(range(n * 4))), flush=True)
"""


def mesh_probe(device: str = "cuda") -> float:
    """One rank of the doctor's mesh check: a data mesh over the world,
    this rank's shard of ``arange(n*4)``, summed over the mesh."""
    import torch
    import torch.distributed as dist

    from ..parallel import create_mesh, shard_batch

    mesh = create_mesh({"data": -1}, device=device, timeout_s=60.0)
    n = mesh.size("data")
    shard = shard_batch(torch.arange(n * 4.0, device=mesh.device), mesh)
    total = shard.sum()
    dist.all_reduce(total)
    out = float(total)
    dist.destroy_process_group()
    return out


def _probe_env() -> Dict[str, str]:
    """The probe child's env: this package importable wherever it runs."""
    import os

    root = str(Path(__file__).resolve().parents[2])
    return dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))


def _check_device_and_mesh(
    device_timeout_s: float, device: str = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Every device-touching check in ONE timed child process, which runs
    in its own session and gets SIGTERM + grace before SIGKILL on a
    timeout (``bench._kill_process_group``)."""
    import subprocess
    import sys
    import tempfile

    from ..bench import _kill_process_group

    # spool child output to temp files, not PIPEs: during the SIGTERM
    # grace a full pipe would block the child's shutdown and burn the
    # grace into a SIGKILL
    with tempfile.TemporaryFile("w+") as out_f, tempfile.TemporaryFile(
        "w+"
    ) as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DEVICE_PROBE, device, str(device_timeout_s)],
            stdout=out_f, stderr=err_f, text=True, env=_probe_env(),
            start_new_session=True,
        )
        try:
            proc.wait(timeout=device_timeout_s)
        except subprocess.TimeoutExpired:
            _kill_process_group(proc, grace=10.0)
            err = {
                "ok": False,
                "error": f"device op hung for {device_timeout_s:.0f}s — "
                "the card or its CUDA stack is wedged or unreachable",
            }
            return err, dict(err)
        out_f.seek(0)
        err_f.seek(0)
        stdout, stderr = out_f.read(), err_f.read()
    backend: Dict[str, Any] = {
        "ok": False,
        "error": (stderr.strip().splitlines() or ["no output"])[-1][:300],
    }
    mesh: Dict[str, Any] = dict(backend)
    for line in stdout.splitlines():
        if line.startswith("DOCTOR_BACKEND"):
            _, n, platform, s = line.split()
            backend = {
                "ok": True,
                "devices": int(n),
                "platform": platform,
                "matmul_sum": float(s),
            }
        elif line.startswith("DOCTOR_MESH"):
            _, n, total, expected = line.split()
            mesh = {
                "ok": float(total) == float(expected),
                "devices": int(n),
                "sharded_sum": float(total),
            }
    return backend, mesh


def _load_config_or_error(
    config_path: Path,
) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    """Parse once for every config-dependent check; any failure (absent
    file, directory, syntax error) becomes a report entry, never a
    traceback — the CLI promises one JSON report regardless."""
    from ..config import load_config

    try:
        return load_config(config_path), None
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"[:300]


def _check_vocab(cfg: Optional[Dict], error: Optional[str]) -> Dict[str, Any]:
    if cfg is None:
        return {"ok": False, "error": error}
    tok = cfg.get("tokenizer") or {}
    vocab = tok.get("vocab_path")
    trained = tok.get("tokenizer_path")
    out: Dict[str, Any] = {
        "vocab_path": vocab,
        "vocab_exists": bool(vocab and Path(vocab).exists()),
        "tokenizer_path": trained,
        "tokenizer_exists": bool(trained and Path(trained).exists()),
    }
    if out["vocab_exists"]:
        out["ok"] = True
        out["note"] = "genuine vocabulary — reference tokenization exact"
    elif out["tokenizer_exists"]:
        out["ok"] = True
        out["note"] = (
            "FALLBACK trained tokenizer — training works but F1 parity "
            "with reference checkpoints needs the real vocab.txt "
            "(README: 'Using the real BERT vocabulary')"
        )
    else:
        out["ok"] = False
        out["error"] = "neither vocab_path nor tokenizer_path exists"
    return out


def _check_data(cfg: Optional[Dict], error: Optional[str]) -> Dict[str, Any]:
    if cfg is None:
        return {"ok": False, "error": error}
    reader = cfg.get("dataset_reader") or {}
    paths = {
        "train_data_path": cfg.get("train_data_path"),
        "validation_data_path": cfg.get("validation_data_path"),
        "anchor_path": reader.get("anchor_path"),
        "cve_path": reader.get("cve_path"),
    }
    missing = sorted(
        k for k, p in paths.items() if p and not Path(p).exists()
    )
    return {"ok": not missing, "paths": paths, "missing": missing}


def _check_native() -> Dict[str, Any]:
    """WHY the native path is off: env opt-out, build failure and
    parity-self-check failure are different diagnoses (the last means
    native and Python normalization disagree — a red flag, not a
    preference)."""
    try:
        from ..data.native import native_status

        status = native_status()
        return {
            # a parity FAILURE fails the check; opt-out or a missed build
            # is degraded-but-fine (the Python path is the specification)
            "ok": status["kind"] not in (
                "parity_failed", "runtime_parity_failed"
            ),
            "state": status["state"],
            "kind": status["kind"],
            "reason": status["reason"],
        }
    except Exception as e:
        return {"ok": False, "error": str(e)[:300]}


def _check_compile_cache() -> Dict[str, Any]:
    try:
        from .platform import kernel_library

        return {"ok": True, **kernel_library()}
    except Exception as e:  # an unreadable source tree
        return {"ok": False, "error": str(e)[:300]}


def run_doctor(
    config: str = "configs/config_memory.json",
    device_timeout_s: float = 90.0,
    skip_device: bool = False,
    device: str = "cuda",
) -> Dict[str, Any]:
    if skip_device:
        backend: Dict[str, Any] = {"ok": True, "skipped": True}
        mesh: Dict[str, Any] = {"ok": True, "skipped": True}
    else:
        backend, mesh = _check_device_and_mesh(device_timeout_s, device)
    cfg, cfg_error = _load_config_or_error(Path(config))
    report: Dict[str, Any] = {
        "backend": backend,
        "mesh": mesh,
        "vocabulary": _check_vocab(cfg, cfg_error),
        "data_artifacts": _check_data(cfg, cfg_error),
        "native_normalizer": _check_native(),
        "compile_cache": _check_compile_cache(),
    }
    report["ok"] = all(
        section.get("ok", False) for section in report.values()
        if isinstance(section, dict)
    )
    return report
