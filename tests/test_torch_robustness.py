"""The trainers' robustness in the port: ``remat``, ``debug_checks`` and the
chaos points ``data.read``, ``ckpt.write`` and ``step.N``.

* ``remat`` recomputes each encoder layer in the backward: the gradients
  equal the un-rematted ones at dropout 0 and at dropout 0.1 on one
  generator seed (the generator is replayed), the generator ends where it
  would without remat, each layer's forward runs twice, and at dropout 0 a
  rematted train step matches the JAX package's ``nn.remat`` step;
* ``debug_checks`` raises ``FloatingPointError`` naming the non-finite
  parameter in all three trainers, with the parameters and the optimizer
  state the pre-step ones;
* the fault points fire as the JAX package's do (``tests/test_fault_tolerance.py``,
  ``tests/test_resilience.py``): ``data.read`` lands in the quarantine,
  ``ckpt.write`` leaves the previous file or checkpoint readable, and
  ``step.N=sigterm`` preempts a train whose resume reaches the
  uninterrupted losses.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from memvul_tpu.data.readers import MemoryReader as JaxMemoryReader
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.resilience import faults as jax_faults
from memvul_tpu.resilience.journal import DeadLetter as JaxDeadLetter
from memvul_tpu.training.optim import make_optimizer as jax_make_optimizer
from memvul_tpu.training.trainer import make_train_step
from memvul_tpu_torch import build
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.data.synthetic import build_workspace, corpus_texts, selfcheck_config
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer
from memvul_tpu_torch.models import bert
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel
from memvul_tpu_torch.pretrain import mlm
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.resilience.io import atomic_write_text
from memvul_tpu_torch.resilience.journal import DeadLetter
from memvul_tpu_torch.training import trainer as ptrainer
from memvul_tpu_torch.training.checkpoint import TrainCheckpointer, read_state
from memvul_tpu_torch.training.metrics import check_finite
from memvul_tpu_torch.training.single_trainer import ClassifierTrainer, ClassifierTrainerConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    faults.reset()
    jax_faults.reset()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("robust"), seed=5)


def _stack(ws, dropout: float, remat: bool = False, seed: int = 2):
    """A port memory model (weights from ``seed``) and one host train stack."""
    tok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size, hidden_dropout=dropout,
                          attention_dropout=dropout, remat=remat)
    model = MemoryModel(cfg, header_dim=32)
    build.init_params(model, seed)
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"],
                          same_diff_ratio={"same": 2, "diff": 2}, sample_neg=0.5, seed=1)
    trainer = ptrainer.MemoryTrainer(
        model, tok, reader, ws["paths"]["train"],
        config=ptrainer.TrainerConfig(batch_size=4, grad_accum=2, max_length=48, warmup_steps=0),
        device="cpu")
    stack, _ = next(iter(trainer._microbatch_stacks()))
    return model, stack


def _to_torch(stack):
    return {k: ({kk: torch.from_numpy(vv).long() for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in stack.items()}


def _first_microbatch(model, stack, **kw):
    """The model's logits on the stack's first microbatch."""
    mb = ptrainer._tree_map(lambda x: x[0], _to_torch(stack))
    return model(mb["sample1"], mb["sample2"], sample2_index=mb.get("sample2_index"), **kw)


# -- remat ---------------------------------------------------------------------


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_gradients_equal_the_plain_ones(ws, dropout):
    grads, gen_states = {}, {}
    for remat in (False, True):
        model, stack = _stack(ws, dropout, remat)
        model.train()
        gen = torch.Generator().manual_seed(7)
        out = _first_microbatch(model, stack, generator=gen)
        out.float().pow(2).mean().backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        gen_states[remat] = gen.get_state()
    assert set(grads[True]) == set(grads[False]) and len(grads[True]) > 20
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=1e-6, atol=1e-9, msg=name)
    # the trainer's generator moves as it would without remat
    assert torch.equal(gen_states[True], gen_states[False])


def test_remat_recomputes_each_layer_and_leaves_scoring_alone(ws):
    model, stack = _stack(ws, 0.1, remat=True)
    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs,
    # before the layer's forward returns
    for layer in model.bert.encoder.layer:
        layer.register_forward_pre_hook(lambda mod, args: calls.append(mod))
    model.train()
    out = _first_microbatch(model, stack, generator=torch.Generator().manual_seed(1))
    forward_calls = len(calls)
    out.float().sum().backward()
    assert len(calls) == 2 * forward_calls > 0  # every layer ran again in the backward
    calls.clear()
    model.eval()
    with torch.no_grad():
        _first_microbatch(model, stack)
    assert len(calls) == forward_calls  # scoring: no checkpoint, no recompute


def test_remat_train_step_matches_the_jax_remat_step(ws):
    _, stack = _stack(ws, 0.0)
    vocab = int(WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"]).vocab_size)
    kw = dict(vocab_size=vocab, hidden_dropout=0.0, attention_dropout=0.0, remat=True)
    jmodel = JaxMemoryModel(JaxBertConfig.tiny(**kw), header_dim=32)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), dummy, dummy))
    host = jax.tree_util.tree_map(np.array, params)
    opt_kw = dict(base_lr=1e-3, warmup_steps=0, grad_clip_norm=1.0)
    tx, opt_state = jax_make_optimizer(params, **opt_kw)
    new_params, _, _, stats = jax.jit(make_train_step(jmodel, tx))(
        params, opt_state, jax.random.PRNGKey(0), stack)
    pcfg = BertConfig.tiny(**kw)
    pmodel = MemoryModel(pcfg, header_dim=32)
    pmodel.load_state_dict(params_from_flax(host, pcfg))
    pmodel.train()
    got = ptrainer.train_step(pmodel, ptrainer.make_optimizer(pmodel.named_parameters(), **opt_kw),
                              _to_torch(stack), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(stats["loss"]), **TOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(stats["grad_norm"]), **TOL)
    want = params_from_flax(jax.device_get(new_params), pcfg)
    for name, value in pmodel.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **TOL)


# -- debug_checks ------------------------------------------------------------------


def _poison(model, name):
    with torch.no_grad():
        dict(model.named_parameters())[name].view(-1)[3] = float("nan")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_intact(model, before, optimizer):
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) or (torch.isnan(v) == torch.isnan(before[k])).all() \
            and torch.equal(torch.nan_to_num(v), torch.nan_to_num(before[k])), k
    assert optimizer.count == 0 and not optimizer.optimizer.state


def test_check_finite_names_the_first_offender():
    w = torch.nn.Parameter(torch.ones(3))
    v = torch.nn.Parameter(torch.ones(2))
    w.grad, v.grad = torch.zeros(3), torch.tensor([0.0, float("inf")])
    check_finite(torch.tensor(1.0), [("w", torch.nn.Parameter(torch.ones(1)))])
    with pytest.raises(FloatingPointError, match="the loss"):
        check_finite(torch.tensor(float("nan")), [("w", w)])
    with pytest.raises(FloatingPointError, match="gradient of 'v'"):
        check_finite(torch.tensor(1.0), [("w", w), ("v", v)])


def test_memory_trainer_debug_checks(ws, tmp_path):
    cfg = selfcheck_config(ws, steps_per_epoch=2, sync_every=1)
    name = "bert.encoder.layer.0.attention.self.query.weight"
    results = {}
    for debug in (False, True):
        trainer = _memory_trainer(ws, cfg, tmp_path / f"ok{debug}", debug_checks=debug)
        results[debug] = trainer.train_epoch()["losses"]
    assert results[True] == results[False]  # the checks change no number
    trainer = _memory_trainer(ws, cfg, tmp_path / "nan", debug_checks=True)
    before = _poison(trainer.model, name)
    with pytest.raises(FloatingPointError, match=f"parameter '{name}'"):
        trainer.train_epoch()
    _assert_intact(trainer.model, before, trainer.optimizer)
    assert trainer.step == 0


def _memory_trainer(ws, cfg, out, **extra):
    tok = build.build_tokenizer(cfg["tokenizer"])
    model = build.build_model(cfg["model"], tok.vocab_size)
    build.init_params(model, 2021)
    tc = dict(cfg["trainer"], seed=2021, serialization_dir=str(out), **extra)
    return ptrainer.MemoryTrainer(
        model, tok, build.build_reader(cfg["dataset_reader"], seed=2021),
        ws["paths"]["train"], ws["paths"]["validation"], ws["paths"]["anchors"],
        config=ptrainer.TrainerConfig(**tc), device="cpu")


def test_classifier_trainer_debug_checks(ws):
    tok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    model = build.build_model({"type": "model_single", "header_dim": 32,
                               "encoder": {"preset": "tiny"}}, tok.vocab_size)
    build.init_params(model, 3)
    trainer = ClassifierTrainer(
        model, tok, build.build_reader({"type": "reader_single"}), ws["paths"]["train"],
        config=ClassifierTrainerConfig(batch_size=4, max_length=32, steps_per_epoch=2,
                                       debug_checks=True, sync_every=1), device="cpu")
    name = "header.dense.weight" if "header.dense.weight" in dict(model.named_parameters()) \
        else next(n for n, _ in model.named_parameters() if n.endswith("weight"))
    before = _poison(trainer.model, name)
    with pytest.raises(FloatingPointError, match=f"parameter '{name}'"):
        trainer.train_epoch()
    _assert_intact(trainer.model, before, trainer.optimizer)


def test_mlm_trainer_debug_checks(ws, tmp_path):
    tok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    corpus = tmp_path / "mlm.txt"
    corpus.write_text("\n".join(corpus_texts(ws["splits"]["train"])[:8]))
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size, hidden_dropout=0.0, attention_dropout=0.0)
    config = mlm.MLMTrainerConfig(batch_size=2, grad_accum=2, max_length=24, num_epochs=1,
                                  warmup_steps=1, seed=11, sync_every=1, debug_checks=True)
    healthy = mlm.MLMTrainer(cfg, tok, config, device="cpu").train(str(corpus))
    plain = mlm.MLMTrainer(cfg, tok, mlm.MLMTrainerConfig(**dict(
        vars(config), debug_checks=False)), device="cpu").train(str(corpus))
    assert healthy["final_loss"] == plain["final_loss"]
    trainer = mlm.MLMTrainer(cfg, tok, config, device="cpu")
    name = "bert.embeddings.LayerNorm.weight"
    before = _poison(trainer.model, name)
    with pytest.raises(FloatingPointError, match=f"parameter '{name}'"):
        trainer.train(str(corpus))
    _assert_intact(trainer.model, before, trainer.optimizer)


# -- fault points -------------------------------------------------------------------


def test_data_read_fault_lands_in_the_quarantine_as_in_the_jax_reader(ws, tmp_path):
    spec = "data.read@3=raise:ValueError:injected malformed record"
    got, want = {}, {}
    for name, reader_cls, dl_cls, fmod, sink in (
            ("port", MemoryReader, DeadLetter, faults, got),
            ("jax", JaxMemoryReader, JaxDeadLetter, jax_faults, want)):
        fmod.configure(spec)
        dead = dl_cls(tmp_path / f"{name}.deadletter")
        reader = reader_cls(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
        sink["urls"] = [inst["meta"]["Issue_Url"] for inst in
                        reader.read(ws["paths"]["test"], split="test", quarantine=dead)]
        dead.close()
        sink["dead"] = json.loads((tmp_path / f"{name}.deadletter").read_text())
        fmod.reset()
    n_corpus = len(json.loads(Path(ws["paths"]["test"]).read_text()))
    assert got["urls"] == want["urls"] and len(got["urls"]) == n_corpus - 1
    assert got["dead"]["reason"] == want["dead"]["reason"]
    assert "injected malformed record" in got["dead"]["reason"]
    # without a quarantine the fault raises (training is fail-fast)
    faults.configure("data.read@2=raise")
    with pytest.raises(RuntimeError, match="injected fault"):
        list(MemoryReader(cve_path=ws["paths"]["cve"]).read(ws["paths"]["test"], split="test"))


def test_ckpt_write_fault_leaves_the_previous_file_and_checkpoint(tmp_path):
    target = tmp_path / "meta.json"
    atomic_write_text(target, "GOOD OLD CONTENT")
    faults.configure("ckpt.write=raise:OSError:disk exploded")
    with pytest.raises(OSError, match="disk exploded"):
        atomic_write_text(target, "half-written garbage")
    assert target.read_text() == "GOOD OLD CONTENT"
    assert list(tmp_path.glob("*.tmp.*")) == []
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(0, {"w": torch.ones(2)})
    ckpt.save_step(5, {"w": torch.full((2,), 5.0)})
    faults.configure("ckpt.write@1=raise:OSError:injected")
    with pytest.raises(OSError, match="injected"):
        ckpt.save_step(6, {"w": torch.full((2,), 6.0)})
    step, state = ckpt.restore_latest_step()
    assert step == 5 and torch.equal(state["w"], torch.full((2,), 5.0))
    # an epoch save fails in its manifest write, after the state committed:
    # the new checkpoint and the one before it both read back
    faults.configure("ckpt.write@1=raise:OSError:injected")
    with pytest.raises(OSError):
        ckpt.save(1, {"w": torch.full((2,), 9.0)})
    epoch, state = ckpt.restore_latest()
    assert epoch == 1 and torch.equal(state["w"], torch.full((2,), 9.0))
    assert ckpt.all_steps("epochs") == [0, 1] and ckpt.verify_manifest("epochs", 0)
    assert torch.equal(read_state(ckpt.directory / "epochs" / "0")["w"], torch.ones(2))


def _loss_trainer(ws, out, log, **extra):
    cfg = selfcheck_config(ws, num_epochs=2, steps_per_epoch=3, sync_every=1, patience=None)
    cfg["model"]["encoder"].update(hidden_dropout=0.0, attention_dropout=0.0)
    return _memory_trainer(ws, cfg, out, step_loss_log=str(log), **extra)


def _read_log(path):
    return {r["step"]: r["loss"] for r in map(json.loads, Path(path).read_text().splitlines())}


@pytest.fixture(scope="module")
def baseline_losses(ws, tmp_path_factory):
    base = tmp_path_factory.mktemp("baseline")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = _loss_trainer(ws, base / "out", base / "loss.jsonl").train()
    finally:
        torch.set_num_threads(threads)
    assert "preempted" not in result
    losses = _read_log(base / "loss.jsonl")
    assert sorted(losses) == list(range(6))
    return losses


def test_step_sigterm_preempts_and_the_resume_matches(ws, tmp_path, baseline_losses):
    out, log = tmp_path / "out", tmp_path / "loss.jsonl"
    faults.configure("step.4=sigterm")  # epoch 1, stack 1 of 3
    result = _loss_trainer(ws, out, log).train()
    faults.reset()
    assert result["preempted"] is True and result["preempt_signal"] == 15
    assert json.loads((out / "PREEMPTED.json").read_text())["step"] == 5
    assert sorted(_read_log(log)) == [0, 1, 2, 3, 4]
    assert "preempted" not in _loss_trainer(ws, out, log).train()
    assert not (out / "PREEMPTED.json").exists()
    combined = _read_log(log)
    assert sorted(combined) == list(range(6))
    for step, loss in baseline_losses.items():
        assert abs(combined[step] - loss) <= 1e-5, step


def test_step_sigterm_in_a_train_subprocess_then_resume(ws, tmp_path, baseline_losses):
    """A real process exit through the signal handler (``MEMVUL_FAULTS`` in
    the child's environment), resumed in this process."""
    out, log = tmp_path / "out", tmp_path / "loss.jsonl"
    script = tmp_path / "child.py"
    script.write_text(
        "import json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "torch.set_num_threads(1)\n"
        "from test_torch_robustness import _loss_trainer\n"
        "from memvul_tpu_torch.data.synthetic import build_workspace\n"
        f"ws = build_workspace({str(tmp_path / 'ws')!r}, seed=5)\n"
        f"t = _loss_trainer(ws, {str(out)!r}, {str(log)!r})\n"
        "r = t.train()\n"
        "print(json.dumps({'preempted': r.get('preempted', False), 'step': t.step}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", MEMVUL_FAULTS="step.2=sigterm")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"preempted": True, "step": 3}
    assert sorted(_read_log(log)) == [0, 1, 2]
    assert "preempted" not in _loss_trainer(ws, out, log).train()
    combined = _read_log(log)
    for step, loss in baseline_losses.items():
        assert abs(combined[step] - loss) <= 1e-5, step


def test_step_fault_fires_at_its_step_in_the_classifier_and_mlm_trainers(ws, tmp_path):
    tok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    model = build.build_model({"type": "model_single", "header_dim": 32,
                               "encoder": {"preset": "tiny"}}, tok.vocab_size)
    trainer = ClassifierTrainer(
        model, tok, build.build_reader({"type": "reader_single"}), ws["paths"]["train"],
        config=ClassifierTrainerConfig(batch_size=4, max_length=32, steps_per_epoch=4),
        device="cpu")
    faults.configure("step.2=raise:RuntimeError:step two")
    with pytest.raises(RuntimeError, match="step two"):
        trainer.train_epoch()
    assert trainer.step == 2
    corpus = tmp_path / "mlm.txt"
    corpus.write_text("\n".join(corpus_texts(ws["splits"]["train"])[:16]))
    mt = mlm.MLMTrainer(BertConfig.tiny(vocab_size=tok.vocab_size), tok,
                        mlm.MLMTrainerConfig(batch_size=2, grad_accum=2, max_length=24,
                                             num_epochs=1, sync_every=1), device="cpu")
    faults.configure("step.1=raise:RuntimeError:step one")
    with pytest.raises(RuntimeError, match="step one"):
        mt.train(str(corpus))
    assert mt.step == 1


def test_bert_docstring_no_longer_calls_remat_ignored():
    assert "accepted and ignored" not in bert.__doc__
