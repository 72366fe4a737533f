"""``python -m memvul_tpu_torch doctor`` (``memvul_tpu_torch/utils/doctor.py``)
against the JAX package's doctor, on the CPU.

The five cases of ``tests/test_doctor.py`` run against the port with
``--device cpu`` or ``--skip-device``; the config-dependent sections
(``vocabulary``, ``data_artifacts``) equal the JAX report's on the same
config, and ``native_normalizer`` reports the same state.  The port's own
sections: ``compile_cache`` names the kernel build directory
(``build/kernels/``) and whether the current sources' library is built;
without ``--device cpu`` the device probe fails here (no card) and the
doctor exits 1.
"""

import json

import pytest

from memvul_tpu.utils.doctor import run_doctor as jax_run_doctor
from memvul_tpu_torch.__main__ import main
from memvul_tpu_torch.data.synthetic import build_workspace, selfcheck_config
from memvul_tpu_torch.ops import _kernels


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("doctor"), seed=7)


def _write_config(ws, path):
    path.write_text(json.dumps(selfcheck_config(ws)))
    return path


def _doctor(argv, capsys):
    rc = main(["doctor", *argv])
    return rc, json.loads(capsys.readouterr().out)


def test_doctor_ok_on_complete_workspace(ws, tmp_path, capsys):
    cfg = _write_config(ws, tmp_path / "config.json")
    rc, report = _doctor(["--config", str(cfg), "--device-timeout", "120", "--device", "cpu"],
                         capsys)
    assert rc == 0, report
    assert report["ok"] is True
    assert report["backend"] == {"ok": True, "devices": 1, "platform": "cpu",
                                 "matmul_sum": 64.0 * 64 * 64}
    assert report["mesh"] == {"ok": True, "devices": 1, "sharded_sum": 6.0}
    assert report["vocabulary"]["ok"] is True
    assert report["data_artifacts"]["missing"] == []
    cache = report["compile_cache"]
    assert cache["dir"] == str(_kernels.BUILD_DIR) and cache["dir"].endswith("build/kernels")
    assert cache["library"] == _kernels.library_path().name
    assert cache["built"] is _kernels.library_path().exists()


def test_doctor_flags_missing_artifacts(ws, tmp_path, capsys):
    cfg_dict = selfcheck_config(ws)
    cfg_dict["train_data_path"] = str(tmp_path / "nope.json")
    cfg_dict["tokenizer"] = {"type": "wordpiece", "vocab_path": str(tmp_path / "no_vocab.txt")}
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(cfg_dict))
    rc, report = _doctor(["--config", str(cfg), "--skip-device"], capsys)
    assert rc == 1
    assert report["ok"] is False
    assert "train_data_path" in report["data_artifacts"]["missing"]
    assert report["vocabulary"]["ok"] is False
    assert report["backend"] == {"ok": True, "skipped": True}
    assert report["mesh"] == {"ok": True, "skipped": True}


def test_doctor_malformed_config_stays_a_report(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text('{"tokenizer": }')
    rc, report = _doctor(["--config", str(bad), "--skip-device"], capsys)
    assert rc == 1
    assert report["vocabulary"]["ok"] is False
    assert "Error" in report["vocabulary"]["error"]
    assert report["data_artifacts"]["error"] == report["vocabulary"]["error"]


def test_doctor_fallback_tokenizer_is_ok_with_note(ws, tmp_path, capsys):
    cfg_dict = selfcheck_config(ws)
    assert "vocab_path" not in (cfg_dict.get("tokenizer") or {})
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(cfg_dict))
    rc, report = _doctor(["--config", str(cfg), "--skip-device"], capsys)
    assert rc == 0
    assert report["vocabulary"]["ok"] is True
    assert "FALLBACK" in report["vocabulary"]["note"]


def test_doctor_missing_config_reports_cleanly(tmp_path, capsys):
    rc, report = _doctor(["--config", str(tmp_path / "absent.json"), "--skip-device"], capsys)
    assert rc == 1
    assert report["vocabulary"]["ok"] is False
    assert "FileNotFoundError" in report["vocabulary"]["error"]


@pytest.fixture
def fresh_normalizers():
    """Both packages' native normalizers in a new process's state (probed
    again at first use), restored afterwards: a test of another file in the
    same worker may leave one disabled or with a stale ``_kind``, and the
    reports compared here read those module globals."""
    from memvul_tpu.data import native as jax_native
    from memvul_tpu_torch.data import native as port_native

    names = ("_lib", "_state", "_reason", "_kind")
    saved = [(mod, {n: getattr(mod, n) for n in names}) for mod in (jax_native, port_native)]
    for mod, _ in saved:
        for n in names:
            setattr(mod, n, None)
    yield
    for mod, values in saved:
        for n, value in values.items():
            setattr(mod, n, value)


@pytest.mark.parametrize("variant", ["complete", "missing", "absent"])
def test_config_sections_equal_the_jax_report(variant, ws, tmp_path, capsys, fresh_normalizers):
    cfg_dict = selfcheck_config(ws)
    if variant == "missing":
        cfg_dict["validation_data_path"] = str(tmp_path / "gone.json")
        cfg_dict["tokenizer"] = {"type": "wordpiece", "vocab_path": str(tmp_path / "v.txt"),
                                 "tokenizer_path": ws["paths"]["tokenizer"]}
    cfg = tmp_path / "config.json"
    if variant != "absent":
        cfg.write_text(json.dumps(cfg_dict))
    rc, ours = _doctor(["--config", str(cfg), "--skip-device"], capsys)
    theirs = jax_run_doctor(config=str(cfg), skip_device=True)
    for section in ("vocabulary", "data_artifacts", "backend", "mesh"):
        assert ours[section] == theirs[section], section
    assert {k: ours["native_normalizer"][k] for k in ("ok", "state", "kind")} \
        == {k: theirs["native_normalizer"][k] for k in ("ok", "state", "kind")}
    assert rc == (0 if ours["ok"] else 1)


def test_doctor_without_a_card_fails_its_device_check(ws, tmp_path, capsys):
    cfg = _write_config(ws, tmp_path / "config.json")
    rc, report = _doctor(["--config", str(cfg)], capsys)
    assert rc == 1 and report["ok"] is False
    assert report["backend"]["ok"] is False and "no CUDA device" in report["backend"]["error"]
    assert report["mesh"]["ok"] is False


def test_platform_resolves_devices_as_the_build_does():
    """``utils/platform.py``: the device resolution is ``build``'s own (not a
    copy), and ``is_cuda_device`` answers the JAX ``is_tpu_backend``'s
    question for a CUDA card."""
    import torch

    from memvul_tpu_torch import build
    from memvul_tpu_torch.utils import platform

    assert platform.resolve_device is build.resolve_device
    assert platform.resolve_device("cpu") == torch.device("cpu")
    assert platform.is_cuda_device("cpu") is False
    assert platform.is_cuda_device() is torch.cuda.is_available()
    assert platform.is_cuda_device("cuda:0") is torch.cuda.is_available()
