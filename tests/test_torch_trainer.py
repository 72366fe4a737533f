"""The port's ``MemoryTrainer`` and ``train`` flow on the CPU:

* against the JAX ``MemoryTrainer`` on ``build_workspace`` +
  ``selfcheck_config`` with dropout 0 and the same carried weights: the
  per-step loss trajectory within 1e-4 and the validation metrics equal;
* resume after an epoch and mid-epoch (``save_every_steps`` and a
  simulated stop signal) replays the uninterrupted run's losses;
* EMA validation scores with a module of its own;
* the checkpointer's best-swap crash windows, manifests and fallbacks;
* a port-trained ``model.tar.gz`` read by ``memvul_tpu.archive.load_archive``
  scores as the port does (1e-5);
* ``python -m memvul_tpu_torch train ... --device cpu`` exits 0, and
  without ``--device`` on a host without CUDA it raises."""

import json
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from memvul_tpu.archive import load_archive as jax_load_archive
from memvul_tpu.build import build_model as jax_build_model
from memvul_tpu.build import build_reader as jax_build_reader
from memvul_tpu.build import build_tokenizer as jax_build_tokenizer
from memvul_tpu.build import init_params as jax_init_params
from memvul_tpu.data.synthetic import build_workspace, selfcheck_config
from memvul_tpu.training.trainer import MemoryTrainer as JaxTrainer
from memvul_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from memvul_tpu_torch import build
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.training import checkpoint as ckpt
from memvul_tpu_torch.training import trainer as ptrainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("trainer"), seed=5)


def _config(ws, **trainer):
    cfg = selfcheck_config(ws, **trainer)
    cfg["model"]["encoder"].update(hidden_dropout=0.0, attention_dropout=0.0)
    return cfg


def _port_trainer(ws, cfg, out, params=None, **extra):
    tok = build.build_tokenizer(cfg["tokenizer"])
    model = build.build_model(cfg["model"], tok.vocab_size)
    if params is None:
        build.init_params(model, 2021)
    else:
        model.load_state_dict(params_from_flax(params, model.config))
    tc = dict(cfg["trainer"], seed=2021, serialization_dir=str(out), **extra)
    return ptrainer.MemoryTrainer(
        model, tok, build.build_reader(cfg["dataset_reader"], seed=2021),
        ws["paths"]["train"], ws["paths"]["validation"], ws["paths"]["anchors"],
        config=ptrainer.TrainerConfig(**tc), device="cpu",
    )


def _losses(result):
    return [x for epoch in result["history"] for x in epoch["training_losses"]]


def test_trajectory_and_validation_match_the_jax_trainer(ws, tmp_path):
    cfg = _config(ws, num_epochs=2, steps_per_epoch=4)
    tok = jax_build_tokenizer(cfg["tokenizer"])
    jmodel = jax_build_model(cfg["model"], tok.vocab_size)
    params = jax.device_get(jax_init_params(jmodel, 2021))
    host = jax.tree_util.tree_map(np.array, params)
    log = tmp_path / "jax_losses.jsonl"
    jtrainer = JaxTrainer(
        jmodel, params, tok, jax_build_reader(cfg["dataset_reader"], seed=2021),
        ws["paths"]["train"], ws["paths"]["validation"], ws["paths"]["anchors"],
        config=JaxTrainerConfig(**dict(cfg["trainer"], seed=2021,
                                       serialization_dir=str(tmp_path / "jax"),
                                       step_loss_log=str(log))),
    )
    want = jtrainer.train()
    want_losses = [json.loads(line)["loss"] for line in log.read_text().splitlines()]

    got = _port_trainer(ws, cfg, tmp_path / "port", params=host).train()
    assert len(_losses(got)) == len(want_losses) == 8
    np.testing.assert_allclose(_losses(got), want_losses, rtol=0, atol=1e-4)
    keys = ["s_precision", "s_recall", "s_f1-score", "s_thres", "s_auc", "s_ave_precision_score",
            "s_num_samples"]
    for mine, ref in zip(got["history"], want["history"]):
        for key in keys:
            assert mine[f"validation_{key}"] == pytest.approx(ref[f"validation_{key}"], abs=1e-9), key
        for key in ("accuracy", "same_f1-score", "diff_f1-score"):
            assert mine[f"training_{key}"] == pytest.approx(ref[f"training_{key}"], abs=1e-9)
    assert got["best_epoch"] == want["best_epoch"]


@pytest.fixture(scope="module")
def uninterrupted(ws, tmp_path_factory):
    # total_steps pinned: a run cut to fewer epochs keeps the same schedule
    cfg = _config(ws, num_epochs=2, steps_per_epoch=4, sync_every=1, total_steps=8)
    out = tmp_path_factory.mktemp("straight")
    return cfg, _losses(_port_trainer(ws, cfg, out).train())


def test_resume_after_an_epoch_replays_the_losses(ws, tmp_path, uninterrupted):
    cfg, want = uninterrupted
    first = _port_trainer(ws, dict(cfg, trainer=dict(cfg["trainer"], num_epochs=1)), tmp_path).train()
    resumed = _port_trainer(ws, cfg, tmp_path)
    rest = resumed.train()
    assert resumed.step == 8
    np.testing.assert_allclose(_losses(first) + _losses({"history": rest["history"][1:]}), want,
                               rtol=0, atol=1e-6)
    assert len(rest["history"]) == 2  # the restored epoch's metrics come back


def test_mid_epoch_stop_and_periodic_checkpoints_resume_exactly(
    ws, tmp_path, uninterrupted, monkeypatch
):
    cfg, want = uninterrupted
    log = tmp_path / "losses.jsonl"
    trainer = _port_trainer(ws, cfg, tmp_path, save_every_steps=2, step_loss_log=str(log))
    original = ptrainer.train_step

    def stop_after_the_fifth_step(*args, **kwargs):
        out = original(*args, **kwargs)
        if trainer.step == 4:  # the step just run is the fifth
            trainer._request_stop(signal.SIGTERM, None)
        return out

    monkeypatch.setattr(ptrainer, "train_step", stop_after_the_fifth_step)
    first = trainer.train()
    monkeypatch.setattr(ptrainer, "train_step", original)
    assert first["preempted"] and first["preempt_signal"] == signal.SIGTERM
    marker = json.loads((tmp_path / "PREEMPTED.json").read_text())
    assert marker == {"signal": signal.SIGTERM, "epoch": 1, "step": 5, "stacks_done": 1}
    assert trainer.checkpointer.all_steps("steps") == [4, 5]
    resumed = _port_trainer(ws, cfg, tmp_path, save_every_steps=2, step_loss_log=str(log))
    result = resumed.train()
    assert not (tmp_path / "PREEMPTED.json").exists()
    assert resumed.step == 8 and len(result["history"]) == 2
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    assert [entry["step"] for entry in logged] == list(range(8))
    np.testing.assert_allclose([entry["loss"] for entry in logged], want, rtol=0, atol=1e-6)


def test_ema_validation_scores_with_its_own_module(ws, tmp_path):
    cfg = _config(ws, num_epochs=1, steps_per_epoch=3)
    trainer = _port_trainer(ws, cfg, tmp_path, ema_decay=0.5)
    trainer.train()
    live = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ema = trainer.ema_model.state_dict()
    assert trainer._val_predictor.model is trainer.ema_model
    assert any(not torch.equal(live[k], ema[k]) for k in live)
    # validation scored the EMA weights: a model loaded with them agrees
    scorer = build.build_model(cfg["model"], trainer.tokenizer.vocab_size)
    scorer.load_state_dict(ema)
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    predictor = SiamesePredictor(scorer, trainer.tokenizer, batch_size=8, max_length=48)
    predictor.encode_anchors(trainer.reader.read_anchors(ws["paths"]["anchors"]))
    metrics = predictor.predict_file(trainer.reader, ws["paths"]["validation"],
                                     tmp_path / "again.json", split="validation")
    epoch = trainer.metrics_history[0]
    assert epoch["validation_s_auc"] == pytest.approx(metrics["auc"], abs=1e-9)
    best = trainer.best_params()
    assert all(torch.equal(best[k], ema[k]) for k in ema)
    trainer.train_epoch()  # the next epoch trains with the live model in train mode
    assert trainer.model.training


def test_nan_guard_and_host_fetch_cadence(ws, tmp_path, monkeypatch):
    cfg = _config(ws, num_epochs=1, steps_per_epoch=4, sync_every=2)
    trainer = _port_trainer(ws, cfg, tmp_path)
    calls = []
    monkeypatch.setattr(ptrainer, "_host_fetch", lambda p: calls.append(len(p)) or ptrainer._fetch_stats(p))
    trainer.train_epoch()
    assert calls == [2, 2]
    with torch.no_grad():
        trainer.model.pair_kernel.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="NaN loss at step"):
        trainer.train_epoch()


def _state(v):
    return {"params": {"w": torch.full((3,), float(v))}}


def test_best_swap_roundtrip_and_crash_windows(tmp_path):
    base = tmp_path / "ck"
    ck = ckpt.TrainCheckpointer(base)
    ck.save(0, _state(1.0), is_best=True)
    ck.save(1, _state(2.0), is_best=True)
    assert float(ck.restore_best()["params"]["w"][0]) == 2.0
    assert not (base / "best_old").exists() and not (base / "best_tmp").exists()
    # crash after the old best moved aside, before the new one landed
    (base / "best").rename(base / "best_old")
    assert float(ck.restore_best()["params"]["w"][0]) == 2.0
    # crash after best_tmp committed and the old best moved aside
    (base / "best").rename(base / "best_old")
    ckpt.write_state(base / "best_tmp", _state(9.0))
    assert float(ck.restore_best()["params"]["w"][0]) == 9.0
    # crash after best_tmp committed, the old best still in place
    ckpt.write_state(base / "best_tmp", _state(11.0))
    assert float(ck.restore_best()["params"]["w"][0]) == 11.0
    assert not (base / "best_tmp").exists()
    # staging litter from a crash mid-write is cleaned by the next save
    (base / "best_tmp.partial-1234").mkdir()
    ck.save(2, _state(3.0), is_best=True)
    assert not (base / "best_tmp.partial-1234").exists()
    assert float(ck.restore_best()["params"]["w"][0]) == 3.0


def test_first_best_crash_and_none_when_never_saved(tmp_path):
    ck = ckpt.TrainCheckpointer(tmp_path / "a")
    assert ck.restore_best() is None
    ckpt.write_state(tmp_path / "a" / "best_tmp", _state(5.0))
    assert float(ck.restore_best()["params"]["w"][0]) == 5.0


def test_manifests_fall_back_past_a_corrupt_newest(tmp_path):
    ck = ckpt.TrainCheckpointer(tmp_path, max_to_keep=2)
    for epoch in range(3):
        ck.save(epoch, _state(epoch), metadata={"epoch": epoch})
    assert ck.all_steps("epochs") == [1, 2]
    assert sorted(p.name for p in tmp_path.glob("manifest_*")) == [
        "manifest_epochs_1.json", "manifest_epochs_2.json"]
    assert ck.verify_manifest("epochs", 2)
    payload = tmp_path / "epochs" / "2" / ckpt.STATE_FILE
    payload.write_bytes(payload.read_bytes()[:-7] + b"corrupt")
    assert not ck.verify_manifest("epochs", 2)
    step, state = ck.restore_latest()
    assert step == 1 and float(state["params"]["w"][0]) == 1.0
    for step in (10, 20, 30):
        ck.save_step(step, _state(step), metadata={"step": step})
    assert ck.all_steps("steps") == [20, 30] and ck.step_metadata(30) == {"step": 30}
    assert not (tmp_path / "step_meta_10.json").exists()
    (tmp_path / "manifest_steps_30.json").write_text("{torn")
    assert ck.restore_latest_step()[0] == 20
    assert json.loads((tmp_path / "metrics_epoch_2.json").read_text()) == {"epoch": 2}


def test_metric_tracker_patience_and_roundtrip():
    tracker = ckpt.MetricTracker("-loss", patience=2)
    assert tracker.update({"loss": 1.0}, 0) and not tracker.update({"loss": 1.5}, 1)
    state = json.loads(json.dumps(tracker.state_dict()))
    again = ckpt.MetricTracker("-loss", patience=2)
    again.load_state_dict(state)
    assert not again.update({"loss": 2.0}, 2) and again.should_stop()
    with pytest.raises(ValueError):
        ckpt.MetricTracker("loss")


def test_port_archive_scores_the_same_in_the_jax_package(ws, tmp_path):
    cfg = selfcheck_config(ws, steps_per_epoch=2)
    cfg["model"]["encoder"]["scan_layers"] = True
    result = build.train_from_config(cfg, tmp_path / "run", device="cpu")
    assert Path(result["archive"]).exists() and (tmp_path / "run" / "metrics.json").exists()
    assert json.loads((tmp_path / "run" / "config.json").read_text()) == cfg
    port = load_archive(result["archive"], device="cpu")
    ref = jax_load_archive(result["archive"])
    rng = np.random.default_rng(0)
    ids = rng.integers(5, port.tokenizer.vocab_size, size=(4, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    bank_ids = rng.integers(5, port.tokenizer.vocab_size, size=(3, 20)).astype(np.int32)
    bank_mask = np.ones_like(bank_ids)
    want_bank = np.asarray(ref.model.apply(ref.params, {"input_ids": bank_ids,
                                                        "attention_mask": bank_mask}))
    want = np.asarray(ref.model.apply(ref.params, {"input_ids": ids, "attention_mask": mask},
                                      anchors=want_bank))
    with torch.no_grad():
        t = lambda x: torch.from_numpy(x).long()  # noqa: E731
        bank = port.model({"input_ids": t(bank_ids), "attention_mask": t(bank_mask)})
        got = port.model({"input_ids": t(ids), "attention_mask": t(mask)}, anchors=bank)
    np.testing.assert_allclose(bank.numpy(), want_bank, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unported_knobs_raise_naming_their_slice(ws, tmp_path):
    cfg = selfcheck_config(ws)
    with pytest.raises(NotImplementedError, match="slice 11"):
        build.train_from_config(dict(cfg, tuning={"profile_dir": "profiles/"}), tmp_path,
                                device="cpu")
    with pytest.raises(ValueError, match="unknown model type"):
        build.train_from_config(dict(cfg, model=dict(cfg["model"], type="model_folding")),
                                tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device"):
        build.train_from_config(cfg, tmp_path, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="checkify"):
        build.train_from_config(dict(cfg, trainer=dict(cfg["trainer"], debug_checks=True)),
                                tmp_path, device="cpu")
    with pytest.raises(ValueError, match="prefetch_depth"):
        build.train_from_config(dict(cfg, trainer=dict(cfg["trainer"], prefetch_depth=0)),
                                tmp_path, device="cpu")


def test_train_cli_on_the_cpu_and_refused_without_cuda(ws, tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(selfcheck_config(ws, steps_per_epoch=1)))
    env = dict(__import__("os").environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "memvul_tpu_torch", "train", str(cfg_path), "-s",
         str(tmp_path / "cli"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["best_epoch"] == 0 and Path(line["archive"]).exists()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build.train_from_config(selfcheck_config(ws), tmp_path / "refused")
    proc = subprocess.run(
        [sys.executable, "-m", "memvul_tpu_torch", "train", str(cfg_path), "-s",
         str(tmp_path / "refused_cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
