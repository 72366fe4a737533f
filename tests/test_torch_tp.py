"""Tensor parallelism and the model axis (``memvul_tpu_torch.parallel.
sharding``; the bank-sharded scorer): the port's rules over its own
parameter names against the JAX package's ``tp_spec_for`` over the
converted names, leaf by leaf; ``validate_divisibility``; and on a 4-rank
gloo world of CPU processes (``data=2 × model=2``):

* the bank-sharded ``SiamesePredictor`` (a bank whose size 2 does not
  divide) against the JAX package's on a ``data=2, model=2`` mesh, rtol
  1e-4 / atol 1e-5 (``tests/test_tp_sharding.py``'s bound);
* the TP forward (local heads, row-parallel all-reduce) and two dp=2 ×
  tp=2 train steps against the single-device port on the global batch:
  loss within rtol 2e-5, every parameter shard within 1e-5 (held against
  single-device torch, not the JAX package's drifting dp×tp test)."""

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).parent


def _stack(rng, k=2, b=4, length=16, vocab=512):
    def sample():
        mask = np.ones((k, b, length), np.int64)
        mask[:, 1, 11:] = 0
        mask[:, 3, 5:] = 0
        return {"input_ids": rng.integers(1, vocab, (k, b, length)), "attention_mask": mask}

    weight = np.ones((k, b), np.float32)
    weight[1, 2:] = 0.0  # dead rows on one data rank's half only
    return {"sample1": sample(), "sample2": sample(),
            "label": rng.integers(0, 2, (k, b)), "weight": weight}


def tp_world(work, predictor_model, paths, anchors_n):
    """One rank of the data=2 × model=2 world: the bank-sharded scores,
    then the TP forward and train steps against a single-device copy."""
    torch.set_num_threads(1)
    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel
    from memvul_tpu_torch.parallel import create_mesh, shard_batch
    from memvul_tpu_torch.parallel.sharding import shard_params, tp_norm_fn
    from memvul_tpu_torch.training.optim import make_optimizer
    from memvul_tpu_torch.training.trainer import to_device, train_step

    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")
    out = {"rank": mesh.rank}
    # -- the bank-sharded predictor
    tok = WordPieceTokenizer(tokenizer_path=paths["tokenizer"])
    model = MemoryModel(BertConfig.tiny(vocab_size=tok.vocab_size))
    model.load_state_dict(torch.load(predictor_model))
    reader = MemoryReader(cve_path=paths["cve"], anchor_path=paths["anchors"])
    anchors = list(reader.read_anchors(paths["anchors"]))[:anchors_n]
    pred = SiamesePredictor(model, tok, batch_size=16, max_length=64, mesh=mesh)
    pred.encode_anchors(anchors)
    out["bank_rows"] = int(pred.anchor_bank.shape[0])
    scores = {}
    for probs, metas in pred.score_instances(reader.read(paths["test"], split="test")):
        for row, meta in zip(probs, metas):
            scores[meta["Issue_Url"]] = row.tolist()
    out["scores"] = scores
    # -- TP forward and two dp×tp steps against the single-device model
    torch.manual_seed(0)
    ref = MemoryModel(BertConfig.tiny(vocab_size=512, hidden_dropout=0.0, attention_dropout=0.0),
                      header_dim=32)
    tp = shard_params(copy.deepcopy(ref), mesh)
    out["q_rows"] = int(tp.bert.encoder.layer[0].attention.self.query.weight.shape[0])
    rng = np.random.default_rng(3)
    stack = _stack(rng)
    first = {k: torch.from_numpy(v[0]) for k, v in stack["sample1"].items()}
    with torch.no_grad():
        want = ref.encode(first["input_ids"], first["attention_mask"])
        got = tp.encode(*shard_batch((first["input_ids"], first["attention_mask"]), mesh))
    i = mesh.index("data")
    out["forward_err"] = float((got - want[i * 2:(i + 1) * 2]).abs().max())
    ref_opt = make_optimizer(ref.named_parameters(), base_lr=1e-3, warmup_steps=0)
    tp_opt = make_optimizer(tp.named_parameters(), base_lr=1e-3, warmup_steps=0)
    tp_opt.norm_fn = tp_norm_fn(tp, tp_opt.params, mesh)
    ref.train()
    tp.train()
    out["losses"], out["norms"] = [], []
    for step in range(2):
        stack = _stack(rng)
        want = train_step(ref, ref_opt, to_device(stack, torch.device("cpu")))
        got = train_step(tp, tp_opt, to_device(shard_batch(stack, mesh, batch_axis=1),
                                              torch.device("cpu")), mesh=mesh)
        out["losses"].append([float(got["loss"]), float(want["loss"])])
        out["norms"].append([float(got["grad_norm"]), float(want["grad_norm"])])
    worst = 0.0
    j, n = mesh.index("model"), mesh.size("model")
    for (name, p), (_, r) in zip(tp.named_parameters(), ref.named_parameters()):
        spec = tp.tp_specs[name]
        if "model" in spec:
            r = r.chunk(n, dim=spec.index("model"))[j]
        worst = max(worst, float((p - r).abs().max()))
    out["param_err"] = worst
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from memvul_tpu.data.synthetic import build_workspace
    from memvul_tpu.models import BertConfig, MemoryModel
    from memvul_tpu_torch.models.bert import BertConfig as PortConfig
    from memvul_tpu_torch.models.convert import params_from_flax
    from memvul_tpu_torch.parallel.launch import run_ranks

    work = tmp_path_factory.mktemp("tp")
    ws = build_workspace(work / "ws", seed=9)
    model = MemoryModel(BertConfig.tiny(vocab_size=ws["tokenizer"].vocab_size))
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(model.init(jax.random.PRNGKey(0), dummy, dummy))
    torch.save(params_from_flax(params, PortConfig.tiny(vocab_size=ws["tokenizer"].vocab_size)),
               work / "model.pt")
    from memvul_tpu.data.readers import MemoryReader

    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors(ws["paths"]["anchors"]))
    n = len(anchors) - (1 - len(anchors) % 2)  # odd: the model axis (2) does not divide it
    results = run_ranks("test_torch_tp:tp_world", 4, work / "world",
                        {"work": str(work), "predictor_model": str(work / "model.pt"),
                         "paths": ws["paths"], "anchors_n": n},
                        timeout_s=120, env={"OMP_NUM_THREADS": "1"}, python_path=[HERE])
    return {"results": results, "ws": ws, "model": model, "params": params,
            "anchors": anchors[:n], "reader": reader}


def test_bank_sharded_predictor_matches_jax_on_data_2_model_2(world):
    import jax

    from memvul_tpu.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu.parallel import create_mesh

    anchors = world["anchors"]
    assert len(anchors) % 2 == 1 and len(anchors) >= 4
    mesh = create_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    pred = SiamesePredictor(world["model"], world["params"], world["ws"]["tokenizer"], mesh=mesh,
                            batch_size=16, max_length=64)
    pred.encode_anchors(anchors)
    want = {}
    for probs, metas in pred.score_instances(world["reader"].read(world["ws"]["paths"]["test"],
                                                                  split="test")):
        for row, meta in zip(probs, metas):
            want[meta["Issue_Url"]] = row
    for res in world["results"]:
        assert res["bank_rows"] == (len(anchors) + 1) // 2  # a padded half of the bank
        got = res["scores"]
        assert got.keys() == want.keys()
        for url, row in want.items():
            assert len(got[url]) == len(anchors)  # the padding columns sliced off
            np.testing.assert_allclose(got[url], row, rtol=1e-4, atol=1e-5)


def test_tp_forward_runs_local_heads_and_matches_one_device(world):
    for res in world["results"]:
        assert res["q_rows"] == 64 // 2  # 2 of the tiny model's 4 heads
        assert res["forward_err"] < 1e-5


def test_dp2_tp2_train_steps_match_one_device(world):
    for res in world["results"]:
        for got, want in res["losses"]:
            assert got == pytest.approx(want, rel=2e-5)
        for got, want in res["norms"]:
            assert got == pytest.approx(want, rel=2e-5)
        assert res["param_err"] < 1e-5


def _jax_path(key: str) -> str:
    """The JAX leaf path of a port parameter name (``models/convert.py``'s
    map, per-layer layout)."""
    parts = key.split(".")
    i, rest = parts[3], ".".join(parts[4:])
    table = {
        "attention.self.query.weight": "attention/query/kernel",
        "attention.self.key.weight": "attention/key/kernel",
        "attention.self.value.weight": "attention/value/kernel",
        "attention.self.query.bias": "attention/query/bias",
        "attention.self.key.bias": "attention/key/bias",
        "attention.self.value.bias": "attention/value/bias",
        "attention.output.dense.weight": "attention/output/kernel",
        "attention.output.dense.bias": "attention/output/bias",
        "intermediate.dense.weight": "intermediate/kernel",
        "intermediate.dense.bias": "intermediate/bias",
        "output.dense.weight": "output/kernel",
        "output.dense.bias": "output/bias",
        "attention.output.LayerNorm.weight": "attention/output_LayerNorm/scale",
        "attention.output.LayerNorm.bias": "attention/output_LayerNorm/bias",
        "output.LayerNorm.weight": "output_LayerNorm/scale",
        "output.LayerNorm.bias": "output_LayerNorm/bias",
    }
    return f"bert/encoder/layer_{i}/{table[rest]}"


def _to_port_layout(leaf: np.ndarray, jax_path: str) -> np.ndarray:
    """A JAX leaf (or a shard of one) in the port's layout."""
    if jax_path.endswith("/kernel"):
        if leaf.ndim == 3 and "/output/" in jax_path:  # [heads, Dh, H] → [H, heads·Dh]
            return leaf.reshape(-1, leaf.shape[-1]).T
        if leaf.ndim == 3:  # [H, heads, Dh] → [heads·Dh, H]
            return leaf.reshape(leaf.shape[0], -1).T
        return leaf.T
    return leaf.reshape(-1)


def test_param_specs_match_jax_leaf_by_leaf():
    """For every parameter, the port's spec shards it iff the JAX spec
    shards the converted leaf, and the port's shard j is JAX's shard j in
    the port's layout."""
    import jax

    from memvul_tpu.models import BertConfig, MemoryModel
    from memvul_tpu.parallel.sharding import tp_spec_for as jax_tp_spec_for
    from memvul_tpu_torch.models.bert import BertConfig as PortConfig
    from memvul_tpu_torch.models.convert import params_from_flax
    from memvul_tpu_torch.models.memory import MemoryModel as PortModel
    from memvul_tpu_torch.parallel.sharding import param_specs

    model = MemoryModel(BertConfig.tiny(vocab_size=512), header_dim=32)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(model.init(jax.random.PRNGKey(0), dummy, dummy))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"])}
    port = PortModel(PortConfig.tiny(vocab_size=512), header_dim=32)
    port.load_state_dict(params_from_flax(params, port.config))
    specs = param_specs(port)
    sd = port.state_dict()
    sharded = 0
    for jpath, leaf in flat.items():  # the JAX rules replicate all but the layers' leaves
        if "encoder/layer_" not in jpath:
            assert "model" not in tuple(jax_tp_spec_for(jpath, leaf.ndim)), jpath
    for key, spec in specs.items():
        if not key.startswith("bert.encoder.layer."):
            assert "model" not in spec, key
            continue
        jpath = _jax_path(key)
        leaf = flat[jpath]
        jspec = tuple(jax_tp_spec_for(jpath, leaf.ndim))
        assert ("model" in spec) == ("model" in jspec), key
        if "model" not in spec:
            continue
        sharded += 1
        for j in range(2):
            mine = sd[key].chunk(2, dim=spec.index("model"))[j].numpy()
            theirs = np.split(leaf, 2, axis=jspec.index("model"))[j]
            np.testing.assert_array_equal(mine, _to_port_layout(theirs, jpath), err_msg=key)
    # per layer: q/k/v weights and biases, the attention output weight, the
    # two FFN weights and the up-projection's bias
    assert sharded == 2 * 10


def test_validate_divisibility_flags_4_heads_over_model_8():
    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel
    from memvul_tpu_torch.parallel.sharding import validate_divisibility

    model = MemoryModel(BertConfig.tiny(vocab_size=64), header_dim=32)
    mesh8 = types.SimpleNamespace(axis_names=("model",), size=lambda axis: 8)
    bad = validate_divisibility(model, mesh8)
    assert any("attention.self.query.weight" in b for b in bad) or any("num_heads" in b for b in bad)
    assert "num_heads=4 % 8" in bad
    mesh2 = types.SimpleNamespace(axis_names=("model",), size=lambda axis: 2)
    assert validate_divisibility(model, mesh2) == []
    mesh_data = types.SimpleNamespace(axis_names=("data",), size=lambda axis: 8)
    assert validate_divisibility(model, mesh_data) == []


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
