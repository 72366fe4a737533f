"""Archives across the two packages: the port reads the JAX package's
``model.tar.gz`` (both layer layouts) with weights carried across
bit-identically, and the JAX package reads the port's archives back."""

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.models import BertConfig, MemoryModel
from memvul_tpu.models.convert import export_bert_state_dict
from memvul_tpu_torch import _msgpack
from memvul_tpu_torch import archive as port_archive
from memvul_tpu_torch.models.convert import params_from_flax


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("arch"), seed=1)


def _config(vocab_size, scan_layers):
    return {
        "tokenizer": {"type": "wordpiece"},
        "model": {
            "type": "model_memory",
            "encoder": {"preset": "tiny", "vocab_size": vocab_size, "scan_layers": scan_layers},
            "use_header": True,
            "header_dim": 32,
        },
    }


def _jax_params(vocab_size, scan_layers, seed=0):
    cfg = BertConfig.tiny(vocab_size=vocab_size, scan_layers=scan_layers)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = MemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(seed), dummy, dummy)
    return cfg, jax.device_get(params)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_port_reads_jax_archive_bit_identically(ws, tmp_path, scan_layers):
    vocab = ws["tokenizer"].vocab_size
    cfg, params = _jax_params(vocab, scan_layers)
    path = jax_archive.save_archive(
        tmp_path / "model.tar.gz", _config(vocab, scan_layers), params,
        tokenizer_file=ws["paths"]["tokenizer"],
    )
    arch = port_archive.load_archive(path, device="cpu")
    p = params["params"]
    want = {
        f"bert.{k}": v
        for k, v in export_bert_state_dict(p["bert"], None, cfg).items()
    }
    want["pooler.dense.weight"] = np.asarray(p["pooler"]["dense"]["kernel"]).T
    want["pooler.dense.bias"] = np.asarray(p["pooler"]["dense"]["bias"])
    want["header.dense.weight"] = np.asarray(p["header"]["dense"]["kernel"]).T
    want["header.dense.bias"] = np.asarray(p["header"]["dense"]["bias"])
    want["pair_kernel"] = np.asarray(p["pair_kernel"])
    carried = params_from_flax(arch.params, arch.model.config)
    assert set(carried) == set(want)
    state = arch.model.state_dict()
    assert set(state) == set(want)
    for key, value in want.items():
        value = np.asarray(value, np.float32)
        assert carried[key].dtype == torch.float32
        np.testing.assert_array_equal(carried[key].numpy(), value, err_msg=key)
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
    assert arch.tokenizer.vocab_size == vocab
    assert arch.model.config.scan_layers == scan_layers


def test_overrides_merge_onto_archived_config(ws, tmp_path):
    vocab = ws["tokenizer"].vocab_size
    _, params = _jax_params(vocab, True)
    path = jax_archive.save_archive(
        tmp_path / "model.tar.gz", _config(vocab, True), params,
        tokenizer_file=ws["paths"]["tokenizer"],
    )
    arch = port_archive.load_archive(
        path, overrides='{"evaluation": {"batch_size": 8,}, // comment\n "model.encoder.dtype": "bfloat16"}',
        device="cpu",
    )
    assert arch.config["evaluation"] == {"batch_size": 8}
    assert arch.model.config.dtype == torch.bfloat16


def test_jax_reads_port_archive(ws, tmp_path):
    vocab = ws["tokenizer"].vocab_size
    _, params = _jax_params(vocab, True, seed=3)
    p = params["params"]
    # mixed leaves: numpy f32, a torch f32 tensor and torch bf16 tensors
    p["pair_kernel"] = torch.from_numpy(np.asarray(p["pair_kernel"]).copy())
    p["header"]["dense"]["kernel"] = torch.tensor(
        np.array(p["header"]["dense"]["kernel"]), dtype=torch.bfloat16
    )
    p["pooler"]["dense"]["bias"] = torch.tensor(
        np.array(p["pooler"]["dense"]["bias"]), dtype=torch.bfloat16
    )
    vocab_txt = tmp_path / "vocab.txt"
    ws["tokenizer"].save_vocab_txt(vocab_txt)
    path = port_archive.save_archive(
        tmp_path / "model.tar.gz", _config(vocab, True), params, tokenizer_file=vocab_txt
    )
    back = jax_archive.load_archive(path)
    assert back.config == _config(vocab, True)
    assert back.tokenizer.vocab_size == vocab

    def compare(mine, theirs, where=""):
        if isinstance(mine, dict):
            assert set(mine) == set(theirs), where
            for k in mine:
                compare(mine[k], theirs[k], f"{where}/{k}")
            return
        if isinstance(mine, torch.Tensor):
            assert str(np.asarray(theirs).dtype) == str(mine.dtype).replace("torch.", ""), where
            np.testing.assert_array_equal(
                np.asarray(theirs, np.float32), mine.float().numpy(), err_msg=where
            )
        else:
            assert np.asarray(theirs).dtype == np.asarray(mine).dtype, where
            np.testing.assert_array_equal(np.asarray(theirs), np.asarray(mine), err_msg=where)

    compare(params, back.params)
    # and the port reads its own archive back, bf16 leaves as bf16 tensors
    again = port_archive.load_archive(path, device="cpu")
    assert again.params["params"]["header"]["dense"]["kernel"].dtype == torch.bfloat16


def test_msgpack_scalars_and_containers_round_trip():
    tree = {
        "a": [1, -1, -33, 200, 70000, 2**40, -(2**40), 1.5, True, False, None],
        "s": "x" * 40,
        "b": b"\x00\x01",
        "scalar": np.float32(2.5),
        "vec": np.arange(3, dtype=np.int64),
        "empty": np.zeros((0, 4), np.float32),
    }
    back = _msgpack.unpackb(_msgpack.packb(tree))
    assert back["a"] == tree["a"] and back["s"] == tree["s"] and back["b"] == tree["b"]
    assert back["scalar"] == np.float32(2.5) and back["scalar"].dtype == np.float32
    np.testing.assert_array_equal(back["vec"], tree["vec"])
    assert back["empty"].shape == (0, 4)


def test_msgpack_refuses_chunked_leaves():
    import msgpack

    data = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.unpackb(data)
