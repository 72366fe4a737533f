"""The port's encoder and memory model against the JAX package's on
carried weights, for both attention impls, in f32 at the conversion
tests' tolerance (rtol 2e-4 / atol 2e-5)."""

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
    with pytest.raises(NotImplementedError, match="ScalarMix"):
        BertEncoder(BertConfig.tiny(last_layer_only=False))
    with pytest.raises(NotImplementedError, match="int8"):
        BertEncoder(BertConfig.tiny(quant="int8"))
    enc = BertEncoder(BertConfig.tiny(max_position_embeddings=16))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        enc(torch.zeros(1, 17, dtype=torch.long), torch.ones(1, 17, dtype=torch.long))
