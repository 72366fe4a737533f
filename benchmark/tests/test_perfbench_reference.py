"""The plain reference against a hand-written float64 NumPy forward, and
against the program's own float32 model at a tiny size."""

import math

import numpy as np
import pytest
import torch

from benchmark.lib.weights import make_weights
from benchmark.reference import memvul_siamese as ref

TINY = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 16,
        "vocab_size": 40, "max_position_embeddings": 12, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, "header_dim": 6, "num_classes": 2}


def _numpy_forward(W, cfg, ids):
    W = {k: v.double().numpy() for k, v in W.items()}
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = h // heads

    def ln(x, name):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + cfg["layer_norm_eps"]) * W[name + ".weight"] + W[name + ".bias"]

    def dense(x, name):
        return x @ W[name + ".weight"].T + W[name + ".bias"]

    n = len(ids)
    x = W["bert.embeddings.word_embeddings.weight"][ids] + \
        W["bert.embeddings.position_embeddings.weight"][:n] + W["bert.embeddings.token_type_embeddings.weight"][0]
    x = ln(x, "bert.embeddings.LayerNorm")
    for i in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        out = np.zeros_like(x)
        q, k, v = (dense(x, f"{p}.attention.self.{s}") for s in ("query", "key", "value"))
        for hd in range(heads):
            sl = slice(hd * dh, (hd + 1) * dh)
            s = q[:, sl] @ k[:, sl].T / math.sqrt(dh)
            e = np.exp(s - s.max(-1, keepdims=True))
            out[:, sl] = (e / e.sum(-1, keepdims=True)) @ v[:, sl]
        x = ln(x + dense(out, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        inner = dense(x, f"{p}.intermediate.dense")
        inner = 0.5 * inner * (1 + np.vectorize(math.erf)(inner / math.sqrt(2)))
        x = ln(x + dense(inner, f"{p}.output.dense"), f"{p}.output.LayerNorm")
    pooled = np.tanh(dense(x[0], "pooler.dense"))
    return np.maximum(dense(pooled, "header.dense"), 0), W["pair_kernel"]


def test_reference_against_numpy():
    W = make_weights(ref.parameter_spec(TINY), 3, "cpu")
    reports = [[1, 5, 7, 2], [1, 9, 9, 9, 30, 2], [1, 2]]
    anchors = [[1, 3, 2], [1, 4, 11, 38, 2]]
    got = ref.probabilities(W, TINY, reports, anchors)
    assert got.shape == (3, 2)
    bank = [_numpy_forward(W, TINY, a)[0] for a in anchors]
    for r, ids in enumerate(reports):
        u, K = _numpy_forward(W, TINY, ids)
        d = u.shape[0]
        for a, v in enumerate(bank):
            logits = u @ K[:d] + v @ K[d:2 * d] + np.abs(u - v) @ K[2 * d:]
            p = np.exp(logits - logits.max())
            assert got[r, a] == pytest.approx(p[0] / p.sum(), abs=1e-6)


def test_reference_against_the_programs_f32_model():
    from memvul_tpu_torch.build import build_model
    from memvul_tpu_torch.models.memory import anchor_probs

    cfg = dict(TINY, vocab_size=64, max_position_embeddings=16)
    model = build_model({"type": "model_memory",
                         "encoder": {"preset": "tiny", "dtype": "float32", "hidden_size": 8,
                                     "num_layers": 2, "num_heads": 2, "intermediate_size": 16,
                                     "max_position_embeddings": 16},
                         "use_header": True, "header_dim": 6}, vocab_size=64).eval()
    W = make_weights(ref.parameter_spec(cfg), 9, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in W.items()}
    model.load_state_dict(W)
    reports = [[1, 5, 7, 2, 0, 0], [1, 9, 9, 9, 30, 2]]
    anchors = [[1, 3, 2], [1, 40, 11, 2]]

    def pad(rows, n):
        ids = torch.tensor([r + [0] * (n - len(r)) for r in rows])
        return ids, (torch.arange(n)[None, :] < torch.tensor([len(r) for r in rows])[:, None]).long()

    lengths = [4, 6]
    reports_trimmed = [r[:n] for r, n in zip(reports, lengths)]
    with torch.no_grad():
        bank = model.encode(*pad(anchors, 4))
        probs = anchor_probs(model({"input_ids": pad(reports_trimmed, 6)[0],
                                    "attention_mask": pad(reports_trimmed, 6)[1]},
                                   anchors=bank, anchor_impl="xla"))
    got = ref.probabilities(W, cfg, reports_trimmed, anchors)
    np.testing.assert_allclose(probs.numpy(), got, atol=2e-6)


def test_weights_are_seeded_and_scaled():
    spec = ref.parameter_spec(TINY)
    a, b = make_weights(spec, 1, "cpu"), make_weights(spec, 1, "cpu")
    c = make_weights(spec, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["pair_kernel"], c["pair_kernel"])
    big = make_weights([("w", (512, 256), ref.MATRIX, 256), ("g", (4096,), ref.LN_WEIGHT, 1)], 1, "cpu")
    assert float(big["w"].std()) == pytest.approx(256 ** -0.5, rel=0.02)
    assert float(big["g"].mean()) == pytest.approx(1.0, abs=0.002)


def test_weights_are_rounded_to_the_served_precision():
    spec = ref.parameter_spec(TINY)
    full, served = make_weights(spec, 4, "cpu"), make_weights(spec, 4, "cpu", "bfloat16")
    assert all(served[k].dtype == torch.bfloat16 for k in served)
    assert all(torch.equal(served[k], full[k].to(torch.bfloat16)) for k in full)
    # the reference reads the rounded weights in float32, whatever they come in
    reports, anchors = [[1, 5, 7, 2], [1, 9, 30, 2]], [[1, 3, 2], [1, 4, 11, 2]]
    widened = {k: v.float() for k, v in served.items()}
    np.testing.assert_array_equal(ref.probabilities(served, TINY, reports, anchors),
                                  ref.probabilities(widened, TINY, reports, anchors))
