"""The port stands alone: it imports nothing of the JAX package nor of
the libraries the card's machine lacks, and it runs on the card unless
the caller asks for the CPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "memvul_tpu_torch"
FORBIDDEN = ("memvul_tpu", "jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "tokenizers",
             "sklearn", "transformers")
# modules each slice added, which the checks below must reach
EXPECTED_MODULES = (
    "memvul_tpu_torch.data.normalize", "memvul_tpu_torch.data.corpus", "memvul_tpu_torch.data.cwe",
    "memvul_tpu_torch.training.optim", "memvul_tpu_torch.training.metrics",
    "memvul_tpu_torch.training.checkpoint", "memvul_tpu_torch.training.trainer",
    "memvul_tpu_torch.models.losses", "memvul_tpu_torch.resilience.io",
    "memvul_tpu_torch.resilience.journal", "memvul_tpu_torch.ops.quant",
    "memvul_tpu_torch.models.single", "memvul_tpu_torch.models.textcnn",
    "memvul_tpu_torch.pretrain.mlm", "memvul_tpu_torch.training.single_trainer",
    "memvul_tpu_torch.evaluate.predict_single",
    "memvul_tpu_torch.resilience.faults", "memvul_tpu_torch.telemetry.sinks",
    "memvul_tpu_torch.distributed.partition", "memvul_tpu_torch.distributed.worker",
    "memvul_tpu_torch.distributed.coordinator", "memvul_tpu_torch.bankops.store",
    "memvul_tpu_torch.bankops.drift", "memvul_tpu_torch.bankops.shadow",
    "memvul_tpu_torch.bankops.promote", "memvul_tpu_torch.models.folding",
    "memvul_tpu_torch.data.analysis",
    "memvul_tpu_torch.telemetry.timeseries", "memvul_tpu_torch.telemetry.alerts",
    "memvul_tpu_torch.telemetry.programs", "memvul_tpu_torch.telemetry.live",
    "memvul_tpu_torch.utils.profiling", "memvul_tpu_torch.serving.incident",
    "memvul_tpu_torch.serving.autoscaler", "memvul_tpu_torch.serving.fleet",
)
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_compare.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_forbidden_modules_blocked():
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import memvul_tpu_torch
names = [m.name for m in pkgutil.walk_packages(memvul_tpu_torch.__path__, "memvul_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import kernel_compare
loaded = sorted(k for k in sys.modules if k.split(".")[0] in {FORBIDDEN!r} and sys.modules[k] is not None)
assert not loaded, loaded
missing = sorted(set({EXPECTED_MODULES!r}) - set(names))
assert not missing, missing
print(len(names))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 15 + len(EXPECTED_MODULES)


def test_default_device_refuses_a_host_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    from memvul_tpu_torch.build import (
        evaluate_from_archive,
        resolve_device,
        serve_from_archive,
        train_from_config,
    )
    from memvul_tpu_torch.build import pretrain_from_config
    from memvul_tpu_torch.evaluate.predict_memory import test_siamese as port_test_siamese
    from memvul_tpu_torch.evaluate.predict_single import test_single as port_test_single
    from memvul_tpu_torch.pretrain.mlm import MLMTrainer
    from memvul_tpu_torch.training.single_trainer import ClassifierTrainer
    from memvul_tpu_torch.training.trainer import MemoryTrainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_from_archive(tmp_path / "missing.tar.gz", tmp_path / "test_x.json", tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_from_archive(tmp_path / "missing.tar.gz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test_siamese(None, None, "t", "g", tmp_path / "r.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_from_config({"train_data_path": "t"}, tmp_path / "run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MemoryTrainer(None, None, None, "t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierTrainer(None, None, None, "t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLMTrainer(None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_from_config({"train_data_path": "t"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test_single(None, None, "t", tmp_path / "r.json")
    assert resolve_device("cpu") == torch.device("cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "memvul_tpu_torch", "serve", str(tmp_path / "missing.tar.gz"),
         "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "serving" not in proc.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
