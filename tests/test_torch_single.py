"""The port's single-text classifiers, MemVul-m (``model_single``) and
TextCNN (``model_cnn``), against the JAX package's on the CPU
(``device="cpu"``, tiny configs, torch on one thread):

* ``WordTokenizer`` ids and vocabulary, and the ``SingleReader`` stream
  with its seed, equal to JAX's;
* ``SingleModel`` and ``TextCNN`` logits on carried weights (f32, 1e-5),
  a row shorter than the largest n-gram and an all-padding row included;
  their initial weights drawn from flax's distributions;
* ``ClassifierTrainer`` trajectories against JAX's at dropout 0 (1e-4, as
  ``test_torch_trainer.py``), validation metrics and best epoch included;
* ``test_single`` records and metrics against JAX's on the same archive,
  and archives of both models read across the two packages;
* ``evaluate_from_archive`` with ``configs/test_config_single.json`` and
  ``test_config_cnn.json`` verbatim; the evaluation keys the single path
  refuses;
* ``train`` with ``configs/config_single.json`` and ``config_cnn.json``
  and ``evaluate`` through the CLI, refused without CUDA."""

import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from memvul_tpu.archive import load_archive as jax_load_archive
from memvul_tpu.archive import save_archive as jax_save_archive
from memvul_tpu.build import _auto_buckets_for_corpus as jax_auto_buckets_for_corpus
from memvul_tpu.build import evaluate_from_archive as jax_evaluate
from memvul_tpu.data.readers import SingleReader as JaxSingleReader
from memvul_tpu.data.synthetic import build_workspace, corpus_texts
from memvul_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from memvul_tpu.data.tokenizer import WordTokenizer as JaxWordTokenizer
from memvul_tpu.evaluate.measure import read_result_lines
from memvul_tpu.evaluate.predict_single import test_single as jax_test_single
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import SingleModel as JaxSingleModel
from memvul_tpu.models.textcnn import TextCNN as JaxTextCNN
from memvul_tpu.training import single_trainer as jax_single_trainer
from memvul_tpu_torch import build
from memvul_tpu_torch.__main__ import main
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.data.readers import SingleReader
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer, WordTokenizer
from memvul_tpu_torch.evaluate.predict_single import test_single as port_test_single
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import flax_from_params, params_from_flax
from memvul_tpu_torch.models.single import SingleModel
from memvul_tpu_torch.models.textcnn import TextCNN
from memvul_tpu_torch.training.single_trainer import ClassifierTrainer, ClassifierTrainerConfig
from memvul_tpu_torch.training.trainer import _training_mesh

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = build_workspace(tmp_path_factory.mktemp("single"), seed=6)
    vocab = Path(ws["paths"]["train"]).with_name("word_vocab.json")
    JaxWordTokenizer.train_from_corpus(corpus_texts(ws["splits"]["train"]), max_vocab=80,
                                       save_path=vocab)
    ws["paths"]["word_vocab"] = str(vocab)
    return ws


def _batch(seed, vocab, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(5, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 3:] = 0  # shorter than the largest n-gram
    mask[2, 7:] = 0
    mask[4] = 0  # all padding
    ids[mask == 0] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _torch(sample):
    return {k: torch.from_numpy(v).long() for k, v in sample.items()}


def _single_cfg(jax_side, vocab, **kw):
    cls = JaxBertConfig if jax_side else BertConfig
    return cls.tiny(vocab_size=vocab, hidden_dropout=0.0, attention_dropout=0.0, **kw)


CNN = dict(embed_dim=16, num_filters=8, ngram_sizes=(2, 3, 4, 5), header_dim=16, dropout=0.0)


# -- tokenizer and reader ------------------------------------------------------------


def test_word_tokenizer_matches(ws, tmp_path):
    texts = corpus_texts(ws["splits"]["train"])
    want = JaxWordTokenizer.train_from_corpus(texts, max_vocab=80)
    got = WordTokenizer.train_from_corpus(texts, max_vocab=80, save_path=tmp_path / "v.json")
    assert json.loads((tmp_path / "v.json").read_text()) == json.loads(
        Path(ws["paths"]["word_vocab"]).read_text())
    assert got.vocab_words == want.vocab_words and got.vocab_size == want.vocab_size == 80
    assert got.pad_id == want.pad_id == 0
    read = WordTokenizer(vocab_path=ws["paths"]["word_vocab"])
    samples = texts[:20] + ["", "   ", "Über CVE-2021 x86_64 naïve!!", "UNSEEN zzzqqq 123 4.5"]
    for text in samples:
        for cap in (None, 3):
            assert got.encode(text, max_length=cap) == want.encode(text, max_length=cap), text
            assert read.encode(text, max_length=cap) == want.encode(text, max_length=cap)
    assert got.encode_many(samples, max_length=7) == want.encode_many(samples, max_length=7)


def test_single_reader_stream_matches(ws):
    got_reader = SingleReader(sample_neg=0.3, seed=5)
    want_reader = JaxSingleReader(sample_neg=0.3, seed=5)
    for _ in range(2):  # a second read subsamples the negatives again
        got = list(got_reader.read(ws["paths"]["train"]))
        want = list(want_reader.read(ws["paths"]["train"]))
        assert got == want and 0 < len(got) < len(ws["splits"]["train"])
    validation = list(SingleReader(sample_neg=0.3, seed=5).read(ws["paths"]["validation"]))
    assert validation == list(JaxSingleReader(sample_neg=0.3, seed=5).read(ws["paths"]["validation"]))
    assert len(validation) == len(ws["splits"]["validation"])
    assert {inst["label"] for inst in validation} == {"pos", "neg"}


# -- models -------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_single_model_logits_match(impl):
    sample = _batch(0, 300)
    jmodel = JaxSingleModel(_single_cfg(True, 300, attention_impl=impl), header_dim=32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), sample))
    pmodel = SingleModel(_single_cfg(False, 300, attention_impl=impl), header_dim=32).eval()
    pmodel.load_state_dict(params_from_flax(params, pmodel.config))
    with torch.no_grad():
        got = pmodel(_torch(sample)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, sample)), **TOL)
    back = flax_from_params(pmodel.state_dict(), pmodel.config)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(flat_back)
    for path, leaf in leaves:
        assert np.array_equal(flat_back[path], np.asarray(leaf)), path


@pytest.mark.parametrize("length", [12, 3])
def test_textcnn_logits_match(length):
    sample = _batch(1, 300, t=length)
    jmodel = JaxTextCNN(vocab_size=300, **CNN)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), _batch(1, 300)))
    pmodel = TextCNN(300, **CNN).eval()
    pmodel.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = pmodel(_torch(sample)).numpy()
    want = np.asarray(jmodel.apply(params, sample))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[4] == 0.0)  # an all-padding row pools zeros: bias-free logits of 0
    back = flax_from_params(pmodel.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        assert np.array_equal(flat_back[path], np.asarray(leaf)), path


def test_initial_weights_follow_flax_defaults():
    """Training from scratch starts where the JAX package's does: the same
    distributions (not the same bits) for every TextCNN weight and the
    single model's header and classifier."""
    jparams = jax.device_get(JaxTextCNN(vocab_size=4000, embed_dim=300, num_filters=256).init(
        jax.random.PRNGKey(0), _batch(0, 4000)))["params"]
    port = build.init_params(TextCNN(4000), seed=3)
    pairs = [(port.embedding.weight, jparams["embedding"]["embedding"]),
             (port.conv_3.weight, jparams["conv_3"]["kernel"]),
             (port.header.weight, jparams["header"]["kernel"]),
             (port.classifier.weight, jparams["classifier"]["kernel"])]
    single = build.init_params(SingleModel(BertConfig.tiny(vocab_size=300), header_dim=512), seed=3)
    jsingle = jax.device_get(JaxSingleModel(JaxBertConfig.tiny(vocab_size=300), header_dim=512).init(
        jax.random.PRNGKey(0), _batch(0, 300)))["params"]
    pairs += [(single.header.dense.weight, jsingle["header"]["dense"]["kernel"]),
              (single.bert.encoder.layer[0].intermediate.dense.weight,
               jsingle["bert"]["encoder"]["layer_0"]["intermediate"]["kernel"])]
    for got, want in pairs:
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.std() == pytest.approx(want.std(), rel=0.05)
        assert np.abs(got).max() <= np.abs(want).max() * 1.1 + 1e-6
        assert np.abs(got).max() >= np.abs(want).max() * 0.8
    assert not port.conv_3.bias.detach().any() and not port.header.bias.detach().any()


# -- training ----------------------------------------------------------------------


def _trainer_dict(**kw):
    base = dict(num_epochs=2, steps_per_epoch=3, batch_size=4, max_length=48, eval_batch_size=8,
                eval_max_length=48, warmup_steps=1, base_lr=1e-3, sync_every=2, patience=3,
                seed=2021)
    base.update(kw)
    return base


def _models(kind, ws):
    """(JAX model, its params, port model with the same weights, JAX
    tokenizer, port tokenizer, model section of a config)."""
    if kind == "single":
        jtok = JaxWordPiece(tokenizer_path=ws["paths"]["tokenizer"])
        ptok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
        jmodel = JaxSingleModel(_single_cfg(True, ptok.vocab_size), header_dim=32)
        pmodel = SingleModel(_single_cfg(False, ptok.vocab_size), header_dim=32)
        section = {"type": "model_single", "header_dim": 32,
                   "encoder": {"preset": "tiny", "hidden_dropout": 0.0, "attention_dropout": 0.0}}
    else:
        jtok = JaxWordTokenizer(vocab_path=ws["paths"]["word_vocab"])
        ptok = WordTokenizer(vocab_path=ws["paths"]["word_vocab"])
        jmodel = JaxTextCNN(vocab_size=ptok.vocab_size, **CNN)
        pmodel = TextCNN(ptok.vocab_size, **CNN)
        # ngram_sizes left at its default: a JSON list there makes the JAX
        # package's TextCNN unhashable, so it cannot score the archive
        # (test_textcnn_archive_with_an_ngram_list)
        section = {k: v for k, v in CNN.items() if k != "ngram_sizes"}
        section["type"] = "model_cnn"
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(4), _batch(0, 200)))
    pmodel.load_state_dict(params_from_flax(params, getattr(pmodel, "config", None)))
    return jmodel, params, pmodel, jtok, ptok, section


@pytest.mark.parametrize("kind", ["single", "cnn"])
def test_classifier_trajectory_matches_jax(ws, tmp_path, monkeypatch, kind):
    jmodel, params, pmodel, jtok, ptok, _ = _models(kind, ws)
    trainer = _trainer_dict(group_lrs={} if kind == "cnn" else None)
    seen = []

    def fetch(pending):
        out = jax.device_get(pending)
        seen.extend(float(s["loss"]) for s in out)
        return out

    monkeypatch.setattr(jax_single_trainer, "_host_fetch", fetch)
    want = jax_single_trainer.ClassifierTrainer(
        jmodel, params, jtok, JaxSingleReader(sample_neg=0.5, seed=2021),
        ws["paths"]["train"], ws["paths"]["validation"],
        config=jax_single_trainer.ClassifierTrainerConfig(
            **dict(trainer, serialization_dir=str(tmp_path / "jax"))),
    ).train()
    port = ClassifierTrainer(
        pmodel, ptok, SingleReader(sample_neg=0.5, seed=2021), ws["paths"]["train"],
        ws["paths"]["validation"],
        config=ClassifierTrainerConfig(**dict(trainer, serialization_dir=str(tmp_path / "port"))),
        device="cpu",
    )
    got = port.train()
    losses = [x for epoch in got["history"] for x in epoch["training_losses"]]
    assert len(losses) == len(seen) == 6
    np.testing.assert_allclose(losses, seen, rtol=0, atol=1e-4)
    for mine, ref in zip(got["history"], want["history"]):
        for key in ("pos_f1-score", "pos_precision", "pos_recall", "auc", "TP", "FP", "TN", "FN"):
            assert mine[f"validation_{key}"] == pytest.approx(ref[f"validation_{key}"], abs=1e-6), key
        assert mine["training_accuracy"] == pytest.approx(ref["training_accuracy"], abs=1e-9)
        assert mine["training_f1-score"] == pytest.approx(ref["training_f1-score"], abs=1e-9)
    assert got["best_epoch"] == want["best_epoch"]
    # resume after the last epoch: nothing left to train, the state restored
    again = ClassifierTrainer(
        type(pmodel)(*([pmodel.config] if kind == "single" else [ptok.vocab_size]),
                     **({"header_dim": 32} if kind == "single" else CNN)),
        ptok, SingleReader(sample_neg=0.5, seed=2021), ws["paths"]["train"],
        config=ClassifierTrainerConfig(**dict(trainer, serialization_dir=str(tmp_path / "port"))),
        device="cpu",
    )
    assert again.maybe_restore() and again.epoch == 2 and again.step == 6
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, port.model.state_dict()[k]), k


def test_classifier_trainer_refusals(ws):
    _, _, pmodel, _, ptok, _ = _models("single", ws)
    reader = SingleReader()
    with pytest.raises(ValueError):
        ClassifierTrainer(pmodel, ptok, reader, ws["paths"]["train"],
                          config=ClassifierTrainerConfig(prefetch_depth=0), device="cpu")
    # debug_checks is ported (slice 11): it constructs, and checks each step
    assert ClassifierTrainer(pmodel, ptok, reader, ws["paths"]["train"],
                             config=ClassifierTrainerConfig(debug_checks=True),
                             device="cpu").config.debug_checks
    # a data × model mesh trains (the model axis holds replicated copies, as
    # in the JAX trainers); another axis raises
    tp_mesh = types.SimpleNamespace(axis_names=("data", "model"), size=lambda axis: 2,
                                    device=torch.device("cpu"), is_primary=True)
    assert _training_mesh(tp_mesh) is tp_mesh
    seq_mesh = types.SimpleNamespace(axis_names=("data", "seq"), size=lambda axis: 2,
                                     device=torch.device("cpu"), is_primary=True)
    with pytest.raises(ValueError, match="data and model axes"):
        ClassifierTrainer(pmodel, ptok, reader, ws["paths"]["train"], device="cpu", mesh=seq_mesh)
    with pytest.raises(ValueError, match="unknown key"):
        build.train_from_config({"model": {"type": "model_cnn"}, "trainer": {"grad_accum": 2}},
                                "/nonexistent/never", device="cpu")


# -- archives and scoring ------------------------------------------------------------


def _config(ws, kind, section, **trainer):
    tok = ({"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]} if kind == "single"
           else {"type": "word", "vocab_path": ws["paths"]["word_vocab"]})
    return {
        "random_seed": 2021, "tokenizer": tok,
        "dataset_reader": {"type": "reader_single", "sample_neg": 0.5},
        "train_data_path": ws["paths"]["train"], "validation_data_path": ws["paths"]["validation"],
        "model": section, "trainer": _trainer_dict(num_epochs=1, **trainer),
        "evaluation": {"batch_size": 8, "max_length": 48},
    }


@pytest.fixture(scope="module")
def archives(ws, tmp_path_factory):
    """A port-trained archive of each model, and one the JAX package wrote."""
    tmp = tmp_path_factory.mktemp("single_archives")
    out = {}
    for kind in ("single", "cnn"):
        jmodel, params, _, _, ptok, section = _models(kind, ws)
        cfg = _config(ws, kind, section, **({"group_lrs": {}} if kind == "cnn" else {}))
        result = build.train_from_config(cfg, tmp / f"port_{kind}", device="cpu")
        jax_path = jax_save_archive(tmp / f"jax_{kind}" / "model.tar.gz", cfg, params,
                                    tokenizer_file=build._tokenizer_file(cfg["tokenizer"]))
        out[kind] = {"port": Path(result["archive"]), "jax": jax_path, "config": cfg}
    return out


@pytest.mark.parametrize("kind", ["single", "cnn"])
def test_archives_read_across_packages(ws, archives, kind):
    for path in (archives[kind]["port"], archives[kind]["jax"]):
        port = load_archive(path, device="cpu")
        ref = jax_load_archive(path)
        sample = _batch(7, port.tokenizer.vocab_size)
        assert port.tokenizer.vocab_size == ref.tokenizer.vocab_size
        assert port.tokenizer.encode("a heap overflow in parse()") == ref.tokenizer.encode(
            "a heap overflow in parse()")
        with torch.no_grad():
            got = port.model(_torch(sample)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref.model.apply(ref.params, sample)), **TOL)


@pytest.mark.parametrize("kind", ["single", "cnn"])
def test_test_single_matches_jax(ws, archives, tmp_path, kind):
    path = archives[kind]["port"]
    port, ref = load_archive(path, device="cpu"), jax_load_archive(path)
    args = dict(batch_size=8, max_length=48, buckets=[16, 32, 48], tokens_per_batch=256)
    want = jax_test_single(ref.model, ref.params, ref.tokenizer, ws["paths"]["test"],
                           tmp_path / "jax.json", tmp_path / "jax_metric.json",
                           reader=JaxSingleReader(), use_mesh=False, **args)
    got = port_test_single(port.model, port.tokenizer, ws["paths"]["test"], tmp_path / "port.json",
                      tmp_path / "port_metric.json", reader=SingleReader(), device="cpu", **args)
    jrec = read_result_lines(tmp_path / "jax.json")
    prec = read_result_lines(tmp_path / "port.json")
    assert [r["Issue_Url"] for r in prec] == [r["Issue_Url"] for r in jrec]
    assert len(prec) == len(ws["splits"]["test"])
    for mine, theirs in zip(prec, jrec):
        assert list(mine) == ["Issue_Url", "label", "predict", "prob"]
        assert mine["label"] == theirs["label"] and mine["predict"] == theirs["predict"]
        assert mine["prob"] == pytest.approx(theirs["prob"], abs=1e-5)
    written = json.loads((tmp_path / "port_metric.json").read_text())
    for key in ("TP", "FN", "TN", "FP", "f1", "prec", "pd&recall", "auc", "num_samples"):
        assert got[key] == pytest.approx(want[key], abs=1e-9) and written[key] == got[key]
    assert sorted(written) == sorted(json.loads((tmp_path / "jax_metric.json").read_text()))
    assert got["stream_shapes"] == [(16, 16), (8, 32), (8, 48)] and got["warmup_s"] > 0


def test_textcnn_archive_with_an_ngram_list(ws, archives, tmp_path):
    """``configs/config_cnn.json`` lists its n-gram sizes.  The JAX package
    cannot score such an archive (flax hashes the module for its shared
    probs program, and a list does not hash); the port scores it as it
    scores the same model with the default sizes."""
    cfg = dict(archives["cnn"]["config"])
    cfg["model"] = dict(cfg["model"], ngram_sizes=[2, 3, 4, 5])
    params = jax_load_archive(archives["cnn"]["port"]).params
    path = jax_save_archive(tmp_path / "listed" / "model.tar.gz", cfg, params,
                            tokenizer_file=ws["paths"]["word_vocab"])
    with pytest.raises(TypeError, match="hash"):
        jax_evaluate(path, ws["paths"]["test"], tmp_path / "jax", use_mesh=False)
    got = build.evaluate_from_archive(path, ws["paths"]["test"], tmp_path / "listed_eval",
                                      device="cpu")
    want = build.evaluate_from_archive(archives["cnn"]["port"], ws["paths"]["test"],
                                       tmp_path / "default_eval", device="cpu")
    assert (tmp_path / "listed_eval" / "model_cnn_result.json").read_bytes() == (
        tmp_path / "default_eval" / "model_cnn_result.json").read_bytes()
    assert got["TP"] == want["TP"] and got["num_samples"] == want["num_samples"]


@pytest.mark.parametrize("config", ["test_config_single.json", "test_config_cnn.json"])
def test_evaluate_reference_configs_verbatim(ws, archives, tmp_path, config):
    kind = "single" if "single" in config else "cnn"
    text = (ROOT / "configs" / config).read_text()
    path = archives[kind]["port"]
    want = jax_evaluate(path, ws["paths"]["test"], tmp_path / "jax", overrides=text, use_mesh=False)
    got = build.evaluate_from_archive(path, ws["paths"]["test"], tmp_path / "port", overrides=text,
                                      device="cpu")
    name = f"model_{kind}"
    jrec = {r["Issue_Url"]: r for r in read_result_lines(tmp_path / "jax" / f"{name}_result.json")}
    prec = {r["Issue_Url"]: r for r in read_result_lines(tmp_path / "port" / f"{name}_result.json")}
    assert set(prec) == set(jrec) and len(prec) == len(ws["splits"]["test"])
    for url, rec in jrec.items():
        assert prec[url]["predict"] == rec["predict"]
        assert prec[url]["prob"] == pytest.approx(rec["prob"], abs=1e-5)
    for key in ("TP", "FN", "TN", "FP", "num_samples"):
        assert got[key] == want[key]
    shapes = got["stream_shapes"]
    if kind == "single":  # auto buckets at max_length 512, clamped to the tiny model's 128
        jarch = jax_load_archive(path)
        buckets = jax_auto_buckets_for_corpus(JaxSingleReader(), jarch.tokenizer,
                                              ws["paths"]["test"], 128, n_buckets=8)
        assert [length for _, length in shapes] == list(buckets) and buckets[-1] <= 128
        assert all(rows * length <= 262144 for rows, length in shapes)
    else:  # TextCNN has no position table: padded to the override's 512
        assert shapes == [(64, 512)]


@pytest.mark.parametrize("override", [
    {"resume": True}, {"quarantine": True}, {"attribute_anchors": True}, {"score_retries": 2},
    {"heartbeat_batches": 1}, {"anchor_match_impl": "xla"},
], ids=lambda o: next(iter(o)))
def test_single_path_refuses_memory_only_keys(ws, archives, tmp_path, override):
    with pytest.raises(ValueError, match=next(iter(override))):
        build.evaluate_from_archive(archives["cnn"]["port"], ws["paths"]["test"], tmp_path,
                                    overrides={"evaluation": override}, device="cpu")


def test_single_path_refuses_a_bank_and_a_threshold(ws, archives, tmp_path):
    with pytest.raises(ValueError, match="anchor bank"):
        build.evaluate_from_archive(archives["cnn"]["port"], ws["paths"]["test"], tmp_path,
                                    golden_file=ws["paths"]["anchors"], device="cpu")
    with pytest.raises(ValueError, match="argmax"):
        build.evaluate_from_archive(archives["cnn"]["port"], ws["paths"]["test"], tmp_path,
                                    thres=0.4, device="cpu")


# -- the CLI -------------------------------------------------------------------------


@pytest.mark.parametrize("config", ["config_single.json", "config_cnn.json"])
def test_train_and_evaluate_shipped_configs_through_the_cli(ws, tmp_path, capsys, config):
    kind = "single" if "single" in config else "cnn"
    tok = ({"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]} if kind == "single"
           else {"type": "word", "vocab_path": ws["paths"]["word_vocab"]})
    model = ({"encoder": {"preset": "tiny", "dtype": "float32"}, "header_dim": 32,
              "pretrained_checkpoint": str(tmp_path / "missing_out_wwm")} if kind == "single"
             else {"embed_dim": 16, "num_filters": 8, "header_dim": 16})
    overrides = json.dumps({
        "tokenizer": tok, "train_data_path": ws["paths"]["train"],
        "validation_data_path": ws["paths"]["validation"], "model": model,
        "dataset_reader": {"sample_neg": 0.5},
        "trainer": {"num_epochs": 1, "steps_per_epoch": 2, "batch_size": 4, "max_length": 48,
                    "eval_batch_size": 8, "eval_max_length": 48, "eval_buckets": [16, 48],
                    "eval_tokens_per_batch": 384},
    })
    run = tmp_path / "run"
    assert main(["train", str(ROOT / "configs" / config), "-s", str(run), "-o", overrides,
                 "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["best_epoch"] == 0 and Path(line["archive"]).exists()
    assert (run / "validation_epoch_0.json").exists()
    test_config = ROOT / "configs" / f"test_{config}"
    assert main(["evaluate", str(run), ws["paths"]["test"], "-o", str(tmp_path / "eval"),
                 "--overrides", test_config.read_text(), "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_samples"] == len(ws["splits"]["test"])
    assert (tmp_path / "eval" / f"model_{kind}_metric_all.json").exists()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", str(ROOT / "configs" / config), "-s", str(tmp_path / "r"), "-o", overrides])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["evaluate", str(run), ws["paths"]["test"], "-o", str(tmp_path / "e2")])
