"""The LFM2-MoE encoder (``models/lfm2.py``) on the CPU: against its plain
float32 reference (``models/lfm2_reference.py``) at a tiny size that keeps
every layer kind (conv, attention, a dense FFN, experts with a routing
choice), its causal and grouped attention, its expert layer and K5's plain
version, the refusals of the paths that do not take it, and its
configuration at the published sizes (built on the meta device)."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from memvul_tpu_torch.build import build_model, encoder_config, init_params
from memvul_tpu_torch.models import lfm2_reference as ref
from memvul_tpu_torch.models.lfm2 import (
    Lfm2Config, Lfm2ShortConv, param_count,
)
from memvul_tpu_torch.models.memory import MemoryModel
from memvul_tpu_torch.ops import flash_attention as fa
from memvul_tpu_torch.ops import moe
from memvul_tpu_torch.ops.attention import dot_product_attention, mask_to_bias, xla_attention
from memvul_tpu_torch.ops.quant import QuantLinear

ROOT = Path(__file__).resolve().parents[1]


def _published(c: Lfm2Config) -> dict:
    """The reference's config: the published keys of ``c``."""
    return {"hidden_size": c.hidden_size, "num_attention_heads": c.num_heads,
            "num_key_value_heads": c.num_kv_heads, "norm_eps": c.norm_eps,
            "rope_theta": c.rope_theta, "layer_types": list(c.layer_types),
            "num_dense_layers": c.num_dense_layers, "num_experts_per_tok": c.num_experts_per_tok,
            "moe_intermediate_size": c.moe_intermediate_size, "norm_topk_prob": c.norm_topk_prob,
            "routed_scaling_factor": c.routed_scaling_factor}


def _model(seed=0, **kw) -> MemoryModel:
    """A tiny LFM2 memory model with weights at a trained model's scale:
    matrices N(0, 1/fan_in), norm scales 1 + N(0, 0.02²), biases N(0, 0.02²)."""
    torch.manual_seed(seed)
    model = MemoryModel(Lfm2Config.tiny(**kw), header_dim=16).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.02 * noise)
            elif name.endswith("expert_bias") or name.endswith(".bias"):
                p.copy_(0.02 * noise)
            else:
                p.copy_(noise / math.sqrt(p.shape[-1]))
    return model


def _batch(lengths, t, vocab, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (len(lengths), t), generator=gen)
    mask = torch.zeros(len(lengths), t, dtype=torch.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return ids, mask


def _reference_embeddings(model, ids, lengths):
    weights = ref.float_weights(dict(model.state_dict()))
    cfg = _published(model.config)
    return torch.stack([ref.embed(weights, cfg, ids[i, :n].tolist())
                        for i, n in enumerate(lengths)])


def test_program_matches_the_reference_in_f32():
    model = _model()
    lengths = [1, 5, 13, 30]
    ids, mask = _batch(lengths, 32, model.config.vocab_size)
    with torch.no_grad():
        got = model.encode(ids, mask)
    want = _reference_embeddings(model, ids, lengths)
    # the same f32 arithmetic in another order (batched GEMMs, the f32 copy
    # of the router, the conv's shifted sums): outputs of order 1 agree to
    # a few f32 ulps through five blocks
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5)


def test_program_in_bf16_stays_near_the_reference():
    model = _model()
    lengths = [3, 17, 31]
    ids, mask = _batch(lengths, 32, model.config.vocab_size)
    want = _reference_embeddings(model, ids, lengths)
    bf16 = model.to(torch.bfloat16)
    object.__setattr__(bf16.config, "dtype", torch.bfloat16)
    with torch.no_grad():
        got = bf16.encode(ids, mask).float()
    err = (got - want).abs().max().item()
    # bf16 keeps 8 bits: each block rounds its GEMMs' outputs and the
    # residual stream to 2^-8 of their size, so five blocks and the header
    # leave a few percent of the outputs' scale, and a near-tie in the
    # router may take another expert; a lost layer or a wrong mask moves
    # them by their own size
    assert err <= 0.1 * want.abs().max().item(), err


def test_answer_does_not_depend_on_the_bucket():
    model = _model()
    ids, mask = _batch([19], 19, model.config.vocab_size, seed=3)
    with torch.no_grad():
        short = model.encode(ids, mask)
        for t in (32, 64):
            padded = torch.zeros(2, t, dtype=ids.dtype)
            padded[0, :19] = ids[0]
            padded[1, :7] = ids[0, :7]
            pmask = torch.zeros(2, t, dtype=torch.int32)
            pmask[0, :19] = 1
            pmask[1, :7] = 1
            long = model.encode(padded, pmask)
            # causal attention and conv: padding never reaches a real
            # token, so only the GEMMs' row blocking (f32 rounding) differs
            assert torch.allclose(long[0], short[0], atol=1e-5, rtol=1e-5)


def test_short_conv_is_causal():
    c = Lfm2Config.tiny()
    conv = Lfm2ShortConv(c)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_()
        x = torch.randn(2, 12, c.hidden_size)
        y = conv(x)
        x2 = x.clone()
        x2[:, 7:] = torch.randn_like(x2[:, 7:])
        y2 = conv(x2)
    assert torch.equal(y[:, :7], y2[:, :7])
    assert not torch.equal(y[:, 7:], y2[:, 7:])


def test_short_conv_is_the_published_equation():
    c = Lfm2Config.tiny()
    conv = Lfm2ShortConv(c)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_(0.0, 0.2)
        x = torch.randn(1, 9, c.hidden_size)
        got = conv(x)[0]
    weights = {f"c.{k}": v for k, v in conv.state_dict().items()}
    want = ref.short_conv(weights, "c", x[0])
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_topk_reads_the_expert_bias():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 16, generator=gen)
    gate = torch.randn(8, 16, generator=gen) / 4
    bias = torch.zeros(8)
    plain, _ = moe.route(x, gate, bias, 2)
    bias[5] = 10.0
    biased, weights = moe.route(x, gate, bias, 2)
    assert (biased == 5).any(dim=1).all()
    assert not (plain == 5).any(dim=1).all()
    # the weights are the scores without the bias, normalised over the pair
    scores = torch.sigmoid(x @ gate.t())
    picked = scores.gather(1, biased)
    assert torch.allclose(weights, picked / (picked.sum(dim=1, keepdim=True) + 1e-6))


def test_dispatch_offsets_and_grouped_gemm_plain_version():
    gen = torch.Generator().manual_seed(1)
    selected = torch.randint(0, 6, (40, 3), generator=gen)
    selected[:, 0] = 2  # an expert with many pairs; some with none
    order, offsets = moe.dispatch(selected, 6)
    flat = selected.reshape(-1)
    assert offsets.dtype == torch.int32
    counts = torch.bincount(flat, minlength=6)
    assert offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    assert torch.equal(flat[order], torch.sort(flat, stable=True).values)
    x = torch.randn(flat.numel(), 32, generator=gen)
    w = torch.randn(6, 2 * 16, 32, generator=gen)
    out = moe.grouped_gemm(x, w, offsets, swiglu=True)
    for e in range(6):
        lo, hi = offsets[e].item(), offsets[e + 1].item()
        acc = x[lo:hi] @ w[e].t()
        want = torch.nn.functional.silu(acc[:, :16]) * acc[:, 16:]
        assert torch.allclose(out[lo:hi], want, atol=1e-5, rtol=1e-5)
    plain = moe.grouped_gemm(x, w, offsets)
    assert plain.shape == (x.shape[0], 32)


def test_moe_layer_matches_the_reference_experts():
    model = _model()
    layer = model.model.layers[2].feed_forward
    x = torch.randn(2, 9, model.config.hidden_size)
    moe.reset_counts()
    with torch.no_grad():
        got = layer(x)
    assert moe.pairs_routed == 18 * model.config.num_experts_per_tok
    assert sum(moe.expert_rows("cpu")) == moe.pairs_routed
    weights = {k: v.float() for k, v in model.state_dict().items()}
    want = torch.stack([ref.experts(weights, "model.layers.2.feed_forward", x[i],
                                    _published(model.config)) for i in range(2)])
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_row_chunks_and_ffn_chunks_give_the_same_answer(monkeypatch):
    from memvul_tpu_torch.models import lfm2

    model = _model()
    lengths = [5, 16, 9, 12, 3]
    ids, mask = _batch(lengths, 16, model.config.vocab_size)
    with torch.no_grad():
        whole = model.encode(ids, mask)
        monkeypatch.setattr(lfm2, "CHUNK_TOKENS", 32)  # two rows a chunk
        monkeypatch.setattr(lfm2, "FFN_CHUNK_TOKENS", 7)
        chunked = model.encode(ids, mask)
    assert torch.allclose(whole, chunked, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
def test_causal_grouped_attention_plain_versions_agree(heads, kv_heads):
    gen = torch.Generator().manual_seed(heads + kv_heads)
    b, t, d = 2, 23, 16
    q = torch.randn(b, t, heads, d, generator=gen)
    k = torch.randn(b, t, kv_heads, d, generator=gen)
    v = torch.randn(b, t, kv_heads, d, generator=gen)
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[1, 15:] = 0
    bias = mask_to_bias(mask)
    flash = fa.flash_attention_reference(q, k, v, bias, causal=True, max_score_bytes=1)
    xla = xla_attention(q, k, v, bias, causal=True)
    routed = dot_product_attention(q, k, v, bias, impl="flash", causal=True)
    assert torch.allclose(flash, xla, atol=1e-5, rtol=1e-5)
    assert torch.equal(routed, fa.flash_attention_reference(q, k, v, bias, causal=True))
    # by hand: head h reads K/V head h // (heads / kv_heads), keys j <= i
    group = heads // kv_heads
    for h in range(heads):
        s = torch.einsum("bid,bjd->bij", q[:, :, h], k[:, :, h // group]) / math.sqrt(d)
        s = s + bias[:, 0]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
        want = torch.softmax(s, dim=-1) @ v[:, :, h // group]
        assert torch.allclose(flash[:, :, h], want, atol=1e-5, rtol=1e-5)


def test_causal_attention_ignores_later_keys():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 20, 4, 16, generator=gen) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 12:] += 5.0
    v2[:, 12:] -= 3.0
    out2 = fa.flash_attention(q, k2, v2, causal=True)
    assert torch.equal(out[:, :12], out2[:, :12])
    assert not torch.equal(out[:, 12:], out2[:, 12:])


def test_causal_and_grouped_attention_refusals():
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="ring"):
        dot_product_attention(q, k, k, impl="ring", causal=True)
    with pytest.raises(ValueError, match="packed"):
        dot_product_attention(q, q, q, segment_ids=torch.ones(1, 8, dtype=torch.int32),
                              causal=True)
    with pytest.raises(ValueError, match="groups"):
        fa.flash_attention_reference(q, torch.randn(1, 8, 3, 16), torch.randn(1, 8, 3, 16))
    with pytest.raises(ValueError, match="self-attention"):
        fa.flash_attention_reference(q, k[:, :5], k[:, :5], causal=True)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention(qg, k, k, causal=True)


def test_quant_turns_the_projections_int8():
    model = _model(quant="int8")
    linears = {n: type(m) for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    assert linears["model.layers.0.conv.in_proj"] is QuantLinear
    assert linears["model.layers.1.self_attn.q_proj"] is QuantLinear
    assert linears["model.layers.0.feed_forward.w1"] is QuantLinear
    assert linears["model.layers.2.feed_forward.gate"] is torch.nn.Linear
    assert all(m.bias is None for n, m in model.named_modules() if isinstance(m, QuantLinear))
    float_model = _model()
    lengths = [6, 21]
    ids, mask = _batch(lengths, 24, float_model.config.vocab_size)
    with torch.no_grad():
        got, want = model.encode(ids, mask), float_model.encode(ids, mask)
    assert not torch.equal(got, want)
    # int8 keeps about 7 bits of each projection's inputs and weights
    assert (got - want).abs().max() < 0.2 * want.abs().max()
    assert {n for n, _ in model.named_parameters()} == \
        {n for n, _ in float_model.named_parameters()}


def test_paths_that_do_not_take_the_encoder_refuse_it(tmp_path, monkeypatch):
    model = _model()
    ids, mask = _batch([4], 8, model.config.vocab_size)
    sample = {"input_ids": ids, "attention_mask": mask}
    with pytest.raises(ValueError, match="lfm2_moe.*packed"):
        model.encode_ragged(dict(sample, position_ids=ids, segment_ids=mask, row_starts=ids[0]))
    with pytest.raises(ValueError, match="lfm2_moe.*training"):
        model(sample, sample)
    for impl in ("ring", "xla"):
        with pytest.raises(ValueError, match=f"lfm2_moe.*attention_impl '{impl}'"):
            Lfm2Config.tiny(attention_impl=impl).validate()
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    class _Tok:
        pad_id = 0

    for impl in ("ragged", "continuous"):
        with pytest.raises(ValueError, match="lfm2_moe.*packed"):
            SiamesePredictor(model, _Tok(), score_impl=impl)
    from memvul_tpu_torch.parallel import sharding

    class _Mesh:
        def size(self, axis):
            return 2

    monkeypatch.setattr(sharding, "replicate", lambda m, mesh: None)
    with pytest.raises(ValueError, match="lfm2_moe.*tensor-parallel"):
        sharding.shard_params(model, _Mesh())
    from memvul_tpu_torch.build import train_from_config

    config = json.loads(json.dumps({"model": {"type": "model_memory",
                                              "encoder": {"arch": "lfm2_moe"}}}))
    config.update(tokenizer={"type": "word", "vocab_path": str(tmp_path / "v.json")})
    (tmp_path / "v.json").write_text(json.dumps({"[PAD]": 0, "[UNK]": 1, "a": 2}))
    with pytest.raises(ValueError, match="lfm2_moe.*training"):
        train_from_config(config, tmp_path / "out", device="cpu")
    with pytest.raises(ValueError, match="lfm2_moe.*model_single"):
        build_model({"type": "model_single", "encoder": {"arch": "lfm2_moe"}}, 512)


def test_published_configuration_builds_on_the_meta_device():
    text = (ROOT / "benchmark" / "configs" / "lfm2-8b-a1b.json").read_text()
    cfg = json.loads(text)
    enc = encoder_config(cfg["program"]["model"]["encoder"], cfg["vocab_size"])
    assert enc.layer_types == tuple(cfg["layer_types"])
    assert (enc.num_layers, enc.hidden_size, enc.num_heads, enc.num_kv_heads) == (24, 2048, 32, 8)
    assert (enc.num_experts, enc.num_experts_per_tok, enc.moe_intermediate_size) == (32, 4, 1792)
    assert enc.dtype == torch.bfloat16 and enc.rope_theta == 1e6
    total, active = param_count(enc)
    assert round(total / 1e9, 2) == 8.34 and round(active / 1e9, 2) == 1.42
    with torch.device("meta"):
        model = build_model(cfg["program"]["model"], cfg["vocab_size"])
    encoder = [p for n, p in model.named_parameters() if n.startswith("model.")]
    assert sum(p.numel() for p in encoder) == total
    assert all(p.dtype == torch.bfloat16 and p.is_meta for p in encoder)
    names = dict(model.named_parameters())
    assert names["model.layers.5.feed_forward.experts.w13"].shape == (32, 3584, 2048)
    assert names["model.layers.5.feed_forward.experts.w2"].shape == (32, 2048, 1792)
    assert names["model.layers.2.self_attn.k_proj.weight"].shape == (512, 2048)


def test_program_cost_counts_the_decoder():
    from memvul_tpu_torch.telemetry.programs import score_cost

    c = Lfm2Config()
    flops, _ = score_cost(c, 4096, [4096], 1, 0, header_dim=512)
    per_token = c.encoder_flops(1.0, 0.0)
    # 2 FLOPs a parameter a token outside the embedding, within the norms' share
    assert per_token == pytest.approx(2 * param_count(c)[1], rel=2e-3)
    assert flops == pytest.approx(c.encoder_flops(4096, 4096 ** 2) + 2 * 2048 * 512)


def test_config_memory_lfm2_and_an_archive_through_evaluate(tmp_path):
    from memvul_tpu_torch.archive import load_archive, save_archive
    from memvul_tpu_torch.build import evaluate_from_archive
    from memvul_tpu_torch.config import load_config
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.models.convert import lfm2_params

    config = load_config(ROOT / "configs" / "config_memory_lfm2.json")
    enc = encoder_config(config["model"]["encoder"], 65536)
    assert (enc.num_layers, enc.num_experts, enc.dtype) == (24, 32, torch.bfloat16)
    ws = build_workspace(tmp_path / "ws", seed=3)
    vocab = ws["tokenizer"].vocab_size
    # the configuration at a CPU-sized depth and width; every key of it is read
    small = json.loads(json.dumps(config))
    small["model"]["encoder"].update(
        vocab_size=vocab, hidden_size=64, num_hidden_layers=4,
        layer_types=["conv", "full_attention", "conv", "full_attention"],
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
        moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2, num_dense_layers=1,
        dtype="float32", attention_impl="flash")
    small["model"]["header_dim"] = 16
    small["dataset_reader"].update(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    small["tokenizer"] = {"type": "wordpiece"}
    model = init_params(build_model(small["model"], vocab), seed=5)
    archive = save_archive(tmp_path / "model.tar.gz", small, lfm2_params(model),
                           tokenizer_file=ws["paths"]["tokenizer"])
    arch = load_archive(archive, device="cpu")
    for name, p in model.state_dict().items():
        assert torch.equal(arch.model.state_dict()[name], p)
    metrics = evaluate_from_archive(
        archive, ws["paths"]["test"], tmp_path / "eval",
        overrides={"evaluation": {"batch_size": 16, "max_length": 64, "buckets": [32, 64],
                                  "tokens_per_batch": None, "aot_warmup": False}},
        device="cpu", use_mesh=False)
    assert set(metrics) and all(np.isfinite(v) for v in metrics.values()
                                if isinstance(v, float))
