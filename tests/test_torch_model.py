"""The port's encoder and memory model against the JAX package's on
carried weights, for both attention impls, in f32 at the conversion
tests' tolerance (rtol 2e-4 / atol 2e-5); and the ScalarMix encoder
(``last_layer_only=False``) against JAX's, through convert and an
archive."""

import numpy as np
import pytest
import torch

import jax

from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.models.memory import anchor_probs as jax_anchor_probs
from memvul_tpu_torch.models.bert import BertConfig, BertEncoder
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel, anchor_probs, best_anchor_score

TOL = dict(rtol=2e-4, atol=2e-5)


def _batch(seed, b=5, t=24, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    for i, n in enumerate(rng.integers(1, t + 1, size=b)):
        mask[i, n:] = 0
    mask[-1] = 0  # a dead (fully padded) row
    return ids, mask


@pytest.fixture(scope="module", params=["xla", "flash"])
def models(request):
    impl = request.param
    jcfg = JaxBertConfig.tiny(vocab_size=300, attention_impl=impl, scan_layers=True)
    jmodel = JaxMemoryModel(jcfg, header_dim=32)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(7), dummy, dummy))
    pcfg = BertConfig.tiny(vocab_size=300, attention_impl=impl, scan_layers=True)
    pmodel = MemoryModel(pcfg, header_dim=32).eval()
    pmodel.load_state_dict(params_from_flax(params, pcfg))
    return jmodel, params, pmodel


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_encoder_matches(models):
    jmodel, params, pmodel = models
    ids, mask = _batch(0)
    from memvul_tpu.models import BertEncoder as JaxBertEncoder

    want = np.asarray(
        JaxBertEncoder(jmodel.config).apply({"params": params["params"]["bert"]}, ids, mask)
    )
    with torch.no_grad():
        got = pmodel.bert(_t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_encode_match_and_probs(models):
    jmodel, params, pmodel = models
    ids, mask = _batch(1)
    bank_ids, bank_mask = _batch(2, b=7)
    u_want = np.asarray(jmodel.apply(params, {"input_ids": ids, "attention_mask": mask}))
    bank_want = np.asarray(
        jmodel.apply(params, {"input_ids": bank_ids, "attention_mask": bank_mask})
    )
    logits_want = np.asarray(
        jmodel.apply(params, {"input_ids": ids, "attention_mask": mask}, anchors=bank_want)
    )
    with torch.no_grad():
        u = pmodel.encode(_t(ids), _t(mask))
        bank = pmodel.encode(_t(bank_ids), _t(bank_mask))
        logits = pmodel.match_anchors(u, bank)
        via_forward = pmodel({"input_ids": _t(ids), "attention_mask": _t(mask)}, anchors=bank)
    np.testing.assert_allclose(u.numpy(), u_want, **TOL)
    np.testing.assert_allclose(bank.numpy(), bank_want, **TOL)
    np.testing.assert_allclose(logits.numpy(), logits_want, **TOL)
    np.testing.assert_array_equal(via_forward.numpy(), logits.numpy())
    probs = anchor_probs(logits)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax_anchor_probs(logits_want)), **TOL)
    best, arg = best_anchor_score(logits)
    np.testing.assert_array_equal(best.numpy(), probs.max(-1).values.numpy())
    assert arg.shape == (ids.shape[0],)


def test_bf16_forward_close_to_f32(models):
    _, params, pmodel = models
    ids, mask = _batch(3)
    cfg16 = pmodel.config.replace(dtype=torch.bfloat16)
    m16 = MemoryModel(cfg16, header_dim=32).eval()
    m16.load_state_dict(pmodel.state_dict())
    with torch.no_grad():
        u16 = m16.encode(_t(ids), _t(mask))
        u32 = pmodel.encode(_t(ids), _t(mask))
    assert u16.dtype == torch.bfloat16
    np.testing.assert_allclose(u16.float().numpy(), u32.numpy(), atol=5e-2, rtol=5e-2)


def test_encoder_guards():
    with pytest.raises(ValueError, match="unknown quant mode"):
        BertEncoder(BertConfig.tiny(quant="int4"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        BertEncoder(BertConfig.tiny(attention_impl="ring"))
    enc = BertEncoder(BertConfig.tiny(max_position_embeddings=16))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        enc(torch.zeros(1, 17, dtype=torch.long), torch.ones(1, 17, dtype=torch.long))


# -- ScalarMix (last_layer_only=False) ------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    """A ScalarMix memory model from JAX-initialised weights, its mixing
    weights and gamma drawn away from their zero/one init."""
    jcfg = JaxBertConfig.tiny(vocab_size=300, scan_layers=True, last_layer_only=False)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(jcfg, header_dim=32).init(jax.random.PRNGKey(5), dummy, dummy))
    mix = params["params"]["bert"]["scalar_mix"]
    assert mix["scalar_weights"].shape == (2,) and mix["gamma"].shape == ()
    mix["scalar_weights"] = np.array([0.7, -0.4], np.float32)
    mix["gamma"] = np.array(1.3, np.float32)
    pcfg = BertConfig.tiny(vocab_size=300, scan_layers=True, last_layer_only=False)
    pmodel = MemoryModel(pcfg, header_dim=32).eval()
    pmodel.load_state_dict(params_from_flax(params, pcfg))
    return JaxMemoryModel(jcfg, header_dim=32), params, pmodel


def test_scalar_mix_encoder_matches_jax(mixed):
    from memvul_tpu.models import BertEncoder as JaxBertEncoder

    jmodel, params, pmodel = mixed
    ids, mask = _batch(4)
    want = np.asarray(
        JaxBertEncoder(jmodel.config).apply({"params": params["params"]["bert"]}, ids, mask)
    )
    with torch.no_grad():
        got = pmodel.bert(_t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    u_want = np.asarray(jmodel.apply(params, {"input_ids": ids, "attention_mask": mask}))
    with torch.no_grad():
        np.testing.assert_allclose(pmodel.encode(_t(ids), _t(mask)).numpy(), u_want, **TOL)
    assert set(k for k in pmodel.state_dict() if "scalar_mix" in k) == {
        "bert.scalar_mix.scalar_weights", "bert.scalar_mix.gamma"}


def test_scalar_mix_equal_weights_is_the_layer_mean():
    from memvul_tpu_torch.models.bert import ScalarMix
    from memvul_tpu_torch.ops.attention import mask_to_bias

    torch.manual_seed(0)
    cfg = BertConfig.tiny(vocab_size=300, num_layers=3, last_layer_only=False)
    enc = BertEncoder(cfg).eval()
    last = BertEncoder(cfg.replace(last_layer_only=True)).eval()
    last.load_state_dict({k: v for k, v in enc.state_dict().items() if "scalar_mix" not in k})
    ids, mask = _batch(5)
    with torch.no_grad():
        layers = []
        hidden = last.embeddings(_t(ids), torch.zeros_like(_t(ids)))
        bias = mask_to_bias(_t(mask), cfg.dtype)
        for layer in last.encoder.layer:
            hidden = layer(hidden, bias)
            layers.append(hidden)
        mean = torch.stack(layers).mean(0)
        np.testing.assert_allclose(enc(_t(ids), _t(mask)).numpy(), mean.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(last(_t(ids), _t(mask)).numpy(), layers[-1].numpy())
        mix = ScalarMix(3)
        stacked = torch.randn(3, 2, 4, 8)
        np.testing.assert_allclose(mix(stacked).numpy(), stacked.mean(0).numpy(), rtol=1e-6, atol=1e-7)


def test_convert_round_trips_scalar_mix(mixed):
    from memvul_tpu_torch.models.convert import flax_from_params

    _, params, pmodel = mixed
    back = flax_from_params(pmodel.state_dict(), pmodel.config)
    mix, want = back["params"]["bert"]["scalar_mix"], params["params"]["bert"]["scalar_mix"]
    np.testing.assert_array_equal(mix["scalar_weights"], want["scalar_weights"])
    np.testing.assert_array_equal(mix["gamma"], want["gamma"])
    assert np.asarray(mix["gamma"]).shape == ()
    again = params_from_flax(back, pmodel.config)
    for key, value in pmodel.state_dict().items():
        assert torch.equal(again[key], value), key
    # the groups of the trainer put the mix with the encoder, as the JAX trainer does
    from memvul_tpu_torch.training.optim import label_params

    labels = label_params(pmodel.state_dict())
    assert labels["bert.scalar_mix.scalar_weights"] == labels["bert.scalar_mix.gamma"] == "embedder"


def test_port_scalar_mix_archive_loads_in_jax(mixed, tmp_path):
    from memvul_tpu import archive as jax_archive_mod
    from memvul_tpu_torch.archive import load_archive, save_archive
    from memvul_tpu_torch.models.convert import flax_from_params

    _, _, pmodel = mixed
    config = {"model": {"type": "model_memory", "header_dim": 32,
                        "encoder": {"preset": "tiny", "vocab_size": 300, "scan_layers": True,
                                    "last_layer_only": False}}}
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + [f"w{i}" for i in range(295)]) + "\n")
    path = save_archive(tmp_path / "model.tar.gz", config,
                        flax_from_params(pmodel.state_dict(), pmodel.config), tokenizer_file=vocab)
    jarch = jax_archive_mod.load_archive(path)
    assert not jarch.model.config.last_layer_only
    ids, mask = _batch(6)
    want = np.asarray(jarch.model.apply(jarch.params, {"input_ids": ids, "attention_mask": mask}))
    with torch.no_grad():
        got = pmodel.encode(_t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    reloaded = load_archive(path, device="cpu").model
    for key, value in pmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[key], value), key
