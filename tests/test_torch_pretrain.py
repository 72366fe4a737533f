"""The port's MLM further pretraining against the JAX package's on the CPU
(``device="cpu"``, tiny configs, torch on one thread):

* ``continuation_flags`` and ``whole_word_mask`` bit-equal to JAX's (same
  vocabulary, same generator), empty and special-only rows included;
* ``MLMModel`` logits and ``mlm_nll_sums`` on carried weights (f32, 1e-5);
  the decoder is the word-embedding ``Parameter`` itself;
* ``MLMTrainer`` updates against JAX's at dropout 0 (loss and weights
  within 1e-5), with an epoch-tail stack whose empty microbatch must not
  dilute the mean; resume, the refusal to clobber a directory, and
  ``evaluate`` against JAX's;
* ``encoder.msgpack`` across the two packages, bit for bit, both layer
  layouts; the vocabulary-size refusal, and the layout refusal where the
  JAX package cannot run the transplanted model;
* ``--export-hf``'s ``pytorch_model.bin`` equal key for key to JAX's;
* ``pretrain`` and ``train`` through the CLI with the shipped configs
  (paths and sizes overridden to a workspace), refused without CUDA."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from memvul_tpu.build import export_hf_checkpoint as jax_export_hf
from memvul_tpu.build import load_pretrained_encoder as jax_load_pretrained_encoder
from memvul_tpu.build import save_encoder_checkpoint as jax_save_encoder
from memvul_tpu.data.synthetic import build_workspace, corpus_texts
from memvul_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.pretrain import mlm as jax_mlm
from memvul_tpu_torch import build
from memvul_tpu_torch.__main__ import main
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import flax_encoder, params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel
from memvul_tpu_torch.pretrain import mlm

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = build_workspace(tmp_path_factory.mktemp("pretrain"), seed=4)
    lines = corpus_texts(ws["splits"]["train"])
    corpus = Path(ws["paths"]["train"]).with_name("train_mlm.txt")
    corpus.write_text("\n".join(lines) + "\n")
    held_out = corpus.with_name("validation_mlm.txt")
    held_out.write_text("\n".join(corpus_texts(ws["splits"]["validation"])[:12]) + "\n")
    ws["paths"].update(mlm=str(corpus), mlm_validation=str(held_out))
    return ws


@pytest.fixture(scope="module")
def tokenizers(ws):
    path = ws["paths"]["tokenizer"]
    return JaxWordPiece(tokenizer_path=path), WordPieceTokenizer(tokenizer_path=path)


def _tiny(jax_side: bool, vocab: int, **kw):
    cls = JaxBertConfig if jax_side else BertConfig
    return cls.tiny(vocab_size=vocab, hidden_dropout=0.0, attention_dropout=0.0, **kw)


# -- masking -------------------------------------------------------------------


def test_continuation_flags_match(tokenizers):
    jtok, ptok = tokenizers
    want = jax_mlm.continuation_flags(jtok)
    got = mlm.continuation_flags(ptok)
    assert want.any() and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ptok.mask_id == jtok.mask_id


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_whole_word_mask_bit_equal(tokenizers, ws, seed):
    jtok, ptok = tokenizers
    texts = corpus_texts(ws["splits"]["train"])[seed * 7: seed * 7 + 6]
    seqs = ptok.encode_many(texts, max_length=40)
    ids = np.full((len(seqs) + 2, 40), ptok.pad_id, np.int32)
    mask = np.zeros_like(ids)
    for i, s in enumerate(seqs):
        ids[i, : len(s)], mask[i, : len(s)] = s, 1
    # a special-only row and an empty row
    ids[-2, :2], mask[-2, :2] = [ptok.cls_id, ptok.sep_id], 1
    special = [ptok.pad_id, ptok.cls_id, ptok.sep_id]
    args = (ptok.mask_id, ptok.vocab_size, mlm.continuation_flags(ptok), special, 0.15)
    got = mlm.whole_word_mask(ids, mask, np.random.default_rng(seed), *args)
    want = jax_mlm.whole_word_mask(ids, mask, np.random.default_rng(seed), *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1][-2:] == mlm.IGNORE).all() and (got[0][-2:] == ids[-2:]).all()
    assert ((got[1][:-2] != mlm.IGNORE).sum(axis=1) >= 1).all()


# -- model ---------------------------------------------------------------------


def _carried_mlm(vocab=300, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(4, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    mask[3] = 0
    jmodel = jax_mlm.MLMModel(_tiny(True, vocab))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids, mask))
    bias = rng.normal(size=vocab).astype(np.float32) * 0.1  # a nonzero decoder bias
    params["params"]["decoder_bias"] = bias
    pmodel = mlm.MLMModel(_tiny(False, vocab)).eval()
    pmodel.load_state_dict(params_from_flax(params, pmodel.config))
    return jmodel, params, pmodel, ids, mask, rng


def test_mlm_model_logits_and_nll_match():
    jmodel, params, pmodel, ids, mask, rng = _carried_mlm()
    want = np.asarray(jmodel.apply(params, ids, mask))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    labels = np.where(rng.random(ids.shape) < 0.3, ids, mlm.IGNORE).astype(np.int32)
    labels[0, 0] = ids[0, 0]
    want_sum, want_n = jax_mlm.mlm_nll_sums(want, labels)
    got_sum, got_n = mlm.mlm_nll_sums(got, torch.from_numpy(labels).long())
    assert float(got_n) == float(want_n) > 0
    assert float(got_sum) == pytest.approx(float(want_sum), rel=1e-5)
    assert float(mlm.mlm_loss(got, torch.from_numpy(labels).long())) == pytest.approx(
        float(jax_mlm.mlm_loss(want, labels)), rel=1e-5)
    # the decoder is the embedding table itself: its gradient has both uses
    names = [n for n, _ in pmodel.named_parameters()]
    assert "bert.embeddings.word_embeddings.weight" in names and len(names) == len(set(names))
    assert not any("decoder.weight" in n for n in names)


# -- trainer -------------------------------------------------------------------


def _trainer_cfg(**kw):
    base = dict(batch_size=2, grad_accum=2, max_length=24, num_epochs=1, learning_rate=3e-3,
                warmup_steps=1, seed=11, sync_every=2, prefetch_depth=2)
    base.update(kw)
    return base


def test_mlm_updates_match_jax_with_an_undiluted_tail(tokenizers, ws, tmp_path):
    jtok, ptok = tokenizers
    # 9 lines at 4 rows a stack: stacks of 4, 4 and 1 row, the last with an
    # empty second microbatch
    lines = corpus_texts(ws["splits"]["train"])[:9]
    corpus = tmp_path / "mlm9.txt"
    corpus.write_text("\n".join(lines))
    vocab = ptok.vocab_size
    jt = jax_mlm.MLMTrainer(_tiny(True, vocab), jtok, jax_mlm.MLMTrainerConfig(**_trainer_cfg()))
    pt = mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(**_trainer_cfg()),
                        device="cpu")
    start = params_from_flax(jax.device_get(jt.params), pt.model.config)
    pt.model.load_state_dict(start)
    want = jt.train(str(corpus))
    got = pt.train(str(corpus))
    assert pt.step == jt.step == 3
    assert got["final_loss"] == pytest.approx(want["final_loss"], abs=1e-5)
    want_params = params_from_flax(jax.device_get(jt.params), pt.model.config)
    moved = 0.0
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((value - start[name]).abs().max()))
    assert moved > 1e-4  # the weights did move
    # the tail stack: its loss is the real microbatch's alone, and so is its
    # gradient (the empty microbatch adds nothing and divides nothing)
    pt._encode_corpus(lines)
    ids, mask, labels = (torch.from_numpy(x.astype(np.int64))
                         for x in list(pt._batches(np.random.default_rng(5)))[-1])
    assert mask[1].sum() == 0 and mask[0].sum() > 0
    model = pt.model
    model.zero_grad()
    alone = mlm.mlm_loss(model(ids[0], mask[0]), labels[0])
    alone.backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    seen = {}
    pt.optimizer.step = lambda: seen.update(
        {n: p.grad.clone() for n, p in model.named_parameters()})
    loss = mlm.mlm_train_step(model, pt.optimizer, ids, mask, labels)
    assert float(loss) == pytest.approx(alone.item(), rel=1e-6)
    for n, g in want_grads.items():
        torch.testing.assert_close(seen[n], g, rtol=1e-6, atol=1e-9)


def test_mlm_resume_clobber_refusal_and_evaluate(tokenizers, ws, tmp_path):
    jtok, ptok = tokenizers
    vocab = ptok.vocab_size
    out = tmp_path / "mlm_out"
    cfg = _trainer_cfg(num_epochs=1, steps_per_epoch=2, output_dir=str(out))
    first = mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(**cfg), device="cpu")
    first.train(ws["paths"]["mlm"])
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    resumed = mlm.MLMTrainer(_tiny(False, vocab), ptok,
                             mlm.MLMTrainerConfig(**dict(cfg, num_epochs=2)), device="cpu")
    resumed._encode_corpus(["a line"])
    assert resumed.maybe_restore() and resumed.start_epoch == 1 and resumed.step == 2
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, saved[k])
    result = mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(**dict(cfg, num_epochs=2)),
                            device="cpu").train(ws["paths"]["mlm"])
    assert len(result["history"]) == 1 and np.isfinite(result["final_loss"])
    # a non-empty directory without checkpoints is not overwritten
    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "notes.txt").write_text("keep me")
    with pytest.raises(ValueError, match="overwrite_output_dir"):
        mlm.MLMTrainer(_tiny(False, vocab), ptok,
                       mlm.MLMTrainerConfig(**_trainer_cfg(output_dir=str(dirty))), device="cpu")
    mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(
        **_trainer_cfg(output_dir=str(dirty), overwrite_output_dir=True)), device="cpu")
    # held-out loss and perplexity on the same weights as JAX's
    jt = jax_mlm.MLMTrainer(_tiny(True, vocab), jtok, jax_mlm.MLMTrainerConfig(**_trainer_cfg()))
    pt = mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(**_trainer_cfg()), device="cpu")
    pt.model.load_state_dict(params_from_flax(jax.device_get(jt.params), pt.model.config))
    want = jt.evaluate(ws["paths"]["mlm_validation"], seed=3)
    got = pt.evaluate(ws["paths"]["mlm_validation"], seed=3)
    assert got["masked_tokens"] == want["masked_tokens"] > 0
    assert got["eval_lines"] == want["eval_lines"] == 12
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)
    assert mlm.MLMTrainer(_tiny(False, vocab), ptok, mlm.MLMTrainerConfig(debug_checks=True),
                          device="cpu").c.debug_checks
    with pytest.raises(ValueError, match="inference-only"):
        mlm.MLMTrainer(_tiny(False, vocab, quant="int8"), ptok, device="cpu")


# -- encoder checkpoints -----------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "layer_i"])
def test_encoder_msgpack_across_packages(tmp_path, scan):
    vocab = 300
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    # the port's encoder → JAX's load_pretrained_encoder, bit for bit
    pmlm = mlm.MLMModel(_tiny(False, vocab, scan_layers=scan))
    encoder = mlm.extract_encoder_params(pmlm)
    path = build.save_encoder_checkpoint(encoder, pmlm.config, tmp_path / "port")
    jmem = JaxMemoryModel(_tiny(True, vocab, scan_layers=scan), header_dim=32)
    jparams = jax.device_get(jmem.init(jax.random.PRNGKey(0), dummy, dummy))
    loaded = jax_load_pretrained_encoder(jparams, path.parent)
    want = _flat(flax_encoder(encoder, pmlm.config))
    got = _flat(loaded["params"]["bert"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    # JAX's encoder → the port's load_pretrained_encoder, bit for bit
    jl = jax_mlm.MLMModel(_tiny(True, vocab, scan_layers=scan))
    jl_params = jax.device_get(jl.init(jax.random.PRNGKey(1), dummy["input_ids"],
                                       dummy["attention_mask"]))
    jpath = jax_save_encoder(jax_mlm.extract_encoder_params(jl_params), tmp_path / "jax")
    pmem = MemoryModel(_tiny(False, vocab, scan_layers=scan), header_dim=32)
    build.load_pretrained_encoder(pmem, jpath)
    want_sd = params_from_flax(jl_params, pmem.config)
    for k, v in pmem.bert.state_dict().items():
        assert torch.equal(v, want_sd["bert." + k]), k


def test_encoder_refusals(tmp_path):
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    pmlm = mlm.MLMModel(_tiny(False, 300))  # layer_i, as further_pretrain.json pretrains
    path = build.save_encoder_checkpoint(mlm.extract_encoder_params(pmlm), pmlm.config, tmp_path)
    # another vocabulary: both packages refuse
    with pytest.raises(ValueError, match="vocab size"):
        build.load_pretrained_encoder(MemoryModel(_tiny(False, 301), header_dim=32), path)
    jmem = JaxMemoryModel(_tiny(True, 301), header_dim=32)
    with pytest.raises(ValueError, match="vocab size"):
        jax_load_pretrained_encoder(jax.device_get(jmem.init(jax.random.PRNGKey(0), dummy, dummy)),
                                    path)
    # another layout: the JAX package transplants, then cannot run the
    # model; the port refuses at load, naming both layouts
    jscan = JaxMemoryModel(_tiny(True, 300, scan_layers=True), header_dim=32)
    transplanted = jax_load_pretrained_encoder(
        jax.device_get(jscan.init(jax.random.PRNGKey(0), dummy, dummy)), path)
    with pytest.raises(Exception, match="layers"):
        jscan.apply(transplanted, dummy)
    with pytest.raises(ValueError, match=r"layer_i \(scan_layers=false\).*stacked layers/layer"):
        build.load_pretrained_encoder(MemoryModel(_tiny(False, 300, scan_layers=True), header_dim=32),
                                      path)
    # another position table (a long-context model): refused by name
    with pytest.raises(ValueError, match="position_embeddings"):
        build.load_pretrained_encoder(
            MemoryModel(_tiny(False, 300, max_position_embeddings=256), header_dim=32), path)


def test_export_hf_matches_jax(tokenizers, tmp_path):
    jtok, ptok = tokenizers
    dummy = np.zeros((2, 8), np.int32)
    jl = jax_mlm.MLMModel(_tiny(True, ptok.vocab_size, scan_layers=True))
    params = jax.device_get(jl.init(jax.random.PRNGKey(2), dummy, np.ones_like(dummy)))
    want_dir = jax_export_hf(jax_mlm.extract_encoder_params(params), jl.config, tmp_path / "jax",
                             tokenizer=jtok)
    pmlm = mlm.MLMModel(_tiny(False, ptok.vocab_size, scan_layers=True))
    pmlm.load_state_dict(params_from_flax(params, pmlm.config))
    got_dir = build.export_hf_checkpoint(mlm.extract_encoder_params(pmlm), pmlm.config,
                                         tmp_path / "port", tokenizer=ptok)
    want = torch.load(want_dir / "pytorch_model.bin")
    got = torch.load(got_dir / "pytorch_model.bin")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert json.loads((got_dir / "config.json").read_text()) == json.loads(
        (want_dir / "config.json").read_text())
    assert (got_dir / "vocab.txt").read_text() == (want_dir / "vocab.txt").read_text()


# -- the CLI -------------------------------------------------------------------------


def _overrides(obj) -> str:
    return json.dumps(obj)


def test_pretrain_then_train_memory_through_the_cli(ws, tmp_path, capsys):
    """``pretrain configs/further_pretrain.json`` at a tiny width with its
    encoder stacked (``scan_layers`` as ``config_memory.json`` has it),
    then ``train configs/config_memory.json`` loading the encoder."""
    out = tmp_path / "out_wwm"
    encoder = {"preset": "tiny", "dtype": "float32", "scan_layers": True}
    pre = _overrides({
        "tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
        "encoder": encoder, "train_data_path": ws["paths"]["mlm"],
        "validation_data_path": ws["paths"]["mlm_validation"], "output_dir": str(out),
        "trainer": {"num_epochs": 1, "steps_per_epoch": 2, "batch_size": 2, "max_length": 32,
                    "warmup_steps": 1},
    })
    rc = main(["pretrain", str(ROOT / "configs" / "further_pretrain.json"), "-o", pre,
               "--export-hf", "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["checkpoint"] == str(out / "encoder.msgpack")
    assert np.isfinite(report["final_loss"]) and report["perplexity"] > 1.0
    assert (Path(report["hf_checkpoint"]) / "pytorch_model.bin").exists()
    overrides = _overrides({
        "tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
        "dataset_reader": {"cve_path": ws["paths"]["cve"], "anchor_path": ws["paths"]["anchors"],
                           "sample_neg": 1.0},
        "train_data_path": ws["paths"]["train"], "validation_data_path": ws["paths"]["validation"],
        "model": {"encoder": encoder, "header_dim": 32, "pretrained_checkpoint": str(out)},
        "trainer": {"num_epochs": 1, "steps_per_epoch": 1, "batch_size": 2, "grad_accum": 1,
                    "max_length": 32, "eval_batch_size": 8, "eval_max_length": 32,
                    "eval_buckets": None, "warmup_steps": 1},
    })
    seen = {}
    original = build.load_pretrained_encoder

    def spy(model, checkpoint):
        seen["checkpoint"] = str(checkpoint)
        original(model, checkpoint)
        seen["bert"] = {k: v.clone() for k, v in model.bert.state_dict().items()}
        return model

    build.load_pretrained_encoder = spy
    try:
        rc = main(["train", str(ROOT / "configs" / "config_memory.json"), "-s",
                   str(tmp_path / "run"), "-o", overrides, "--device", "cpu"])
    finally:
        build.load_pretrained_encoder = original
    assert rc == 0 and seen["checkpoint"] == str(out)
    from memvul_tpu_torch import _msgpack
    from memvul_tpu_torch.models.convert import encoder_from_flax

    tree = _msgpack.unpackb((out / "encoder.msgpack").read_bytes())
    want = encoder_from_flax(tree, build.encoder_config(encoder, 2048))
    for k, v in seen["bert"].items():
        assert torch.equal(v, want[k]), k
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert Path(line["archive"]).exists()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["pretrain", str(ROOT / "configs" / "further_pretrain.json"), "-o", pre])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", str(ROOT / "configs" / "config_memory.json"), "-s", str(tmp_path / "r"),
              "-o", overrides])


def test_pretrain_cli_fails_fast_on_an_unusable_validation_file(ws, tmp_path, capsys):
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n")
    pre = _overrides({
        "tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
        "train_data_path": ws["paths"]["mlm"], "validation_data_path": str(empty),
        "output_dir": str(tmp_path / "never"),
    })
    assert main(["pretrain", str(ROOT / "configs" / "further_pretrain.json"), "-o", pre,
                 "--device", "cpu"]) == 2
    assert "validation_data_path unusable" in capsys.readouterr().err
    assert not (tmp_path / "never").exists()
    # a trainer key the MLM trainer does not have raises before any work
    bogus = json.dumps(dict(json.loads(pre), validation_data_path=None,
                            trainer={"grad_accumulation": 2}))
    with pytest.raises(ValueError, match="unknown key.*grad_accumulation"):
        main(["pretrain", str(ROOT / "configs" / "further_pretrain.json"), "-o", bogus,
              "--device", "cpu"])
    assert not (tmp_path / "never").exists()
