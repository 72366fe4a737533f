"""The LFM2 cell's frozen arithmetic (``lib/cost_lfm2.py``) against the
program's own count and the published sizes, its readers on a synthetic
run, and its reference's parameters against the program's."""

import json

import pytest
import torch

from benchmark.lib import cost_lfm2, manifest

CFG = manifest.config("lfm2-8b-a1b")


def test_the_configuration_is_the_published_one():
    catalog = {
        "conv_L_cache": 3, "conv_bias": False, "hidden_size": 2048, "intermediate_size": 7168,
        "max_position_embeddings": 128000, "model_type": "lfm2_moe",
        "moe_intermediate_size": 1792, "norm_eps": 1e-05, "norm_topk_prob": True,
        "num_attention_heads": 32, "num_dense_layers": 2, "num_experts": 32,
        "num_experts_per_tok": 4, "num_hidden_layers": 24, "num_key_value_heads": 8,
        "rope_theta": 1000000, "routed_scaling_factor": 1, "use_expert_bias": True,
        "vocab_size": 65536}
    assert {k: CFG[k] for k in catalog} == catalog
    attention = [i for i, t in enumerate(CFG["layer_types"]) if t == "full_attention"]
    assert attention == [2, 6, 10, 14, 18, 21] and len(CFG["layer_types"]) == 24
    entry = manifest.by_name(manifest.manifest()["configs"], "lfm2-8b-a1b", "configuration")
    assert entry["reduced"] == [] and entry["source"] == CFG["source"]
    encoder = CFG["program"]["model"]["encoder"]
    assert {k: encoder[k] for k in catalog if k in encoder} == \
        {k: CFG[k] for k in catalog if k in encoder}


def test_token_flops_are_twice_the_active_parameters():
    from memvul_tpu_torch.models.lfm2 import Lfm2Config, param_count

    _, active = param_count(Lfm2Config())
    # two FLOPs a parameter a token, less the norms, plus the conv's taps
    # and gates (about 8·D a conv layer)
    assert cost_lfm2.token_flops(CFG) == pytest.approx(2 * active, rel=2e-3)
    assert cost_lfm2.token_flops(CFG) == pytest.approx(Lfm2Config().encoder_flops(1.0, 0.0))


def test_useful_flops_count_causal_attention_at_real_lengths():
    one = cost_lfm2.useful_flops(CFG, [100], 0)
    two = cost_lfm2.useful_flops(CFG, [100, 100], 0)
    assert two == pytest.approx(2 * one)
    attn = 6 * 2.0 * 2048 * (4096 * 4097 - 100 * 101)
    assert cost_lfm2.useful_flops(CFG, [4096], 0) - one == pytest.approx(
        cost_lfm2.token_flops(CFG) * 3996 + attn)
    assert cost_lfm2.useful_flops(CFG, [100], 129) > one


def test_kernel_bounds():
    # causal [64, 4096, 32 / 8, 64]: 4.40e12 FLOPs, 4.45 ms; bytes 0.80 ms
    flops, nbytes = cost_lfm2.attention_launch(CFG, 64, 4096)
    assert flops == 2.0 * 64 * 32 * 64 * 4096 * 4097
    assert cost_lfm2.roofline_seconds(flops, nbytes) * 1e3 == pytest.approx(4.45, abs=0.01)
    # a layer's experts at 262144 slots: 23.3 ms of tensor-core time
    flops, nbytes = cost_lfm2.moe_layer(CFG, 4096, 64)
    assert flops == 2.0 * 262144 * 4 * 3 * 2048 * 1792
    assert nbytes / cost_lfm2.PEAK_HBM_BYTES_PER_S < flops / cost_lfm2.PEAK_BF16_FLOPS
    assert cost_lfm2.roofline_seconds(flops, nbytes) * 1e3 == pytest.approx(23.35, abs=0.01)


def _run(kernels, launches):
    device = []
    t = 0
    for name, dur in kernels:
        device.append((name, t, t + dur))
        t += dur + 10
    return {"config": CFG, "trace": {"device": device, "window": [0, t]}, "launches": launches,
            "lengths_in_window": [100, 4096], "n_anchors": 129, "window_s": 51.0, "chips": 1}


def test_readers_on_a_synthetic_trace():
    k2 = manifest.reader("k2_roofline.lfm2.score")
    k5 = manifest.reader("moe_gemm_roofline.lfm2.score")
    mfu = manifest.reader("mfu.lfm2.score")
    launches = [(64, 4096), (4096, 64)]
    bound_ns = [cost_lfm2.roofline_seconds(*cost_lfm2.attention_launch(CFG, r, n)) * 1e9
                for r, n in launches]
    attn = [("flash_fwd_wgmma_kernel", int(2 * bound_ns[k // 6])) for k in range(12)]
    moe_ns = [cost_lfm2.roofline_seconds(*cost_lfm2.moe_layer(CFG, r, n)) * 1e9
              for r, n in launches]
    experts = [("grouped_gemm_kernel", int(moe_ns[k // 44] / 2)) for k in range(88)]
    run = _run(attn + experts + [("grouped_gemm_kernel", 5)], launches)
    assert k2.read(run) == pytest.approx(50.0, rel=1e-6)
    assert k5.read(run) == pytest.approx(100.0, rel=1e-6)
    expected = cost_lfm2.useful_flops(CFG, [100, 4096], 129) / (51.0 * 989e12) * 100
    assert mfu.read(run) == pytest.approx(expected)
    with pytest.raises(RuntimeError):
        k2.read(_run(attn + attn[:1], launches))
    # the BERT cells' runs and a run without a trace give nothing
    bert = dict(run, config=manifest.config("memvul-longctx"))
    assert k2.read(bert) is None and k5.read(bert) is None and mfu.read(bert) is None
    assert k5.read(dict(run, trace=None)) is None


def test_reference_parameters_are_the_programs():
    from memvul_tpu_torch.build import build_model
    from benchmark.reference import lfm2_siamese

    spec = {name: shape for name, shape, _, _ in lfm2_siamese.parameter_spec(CFG)}
    with torch.device("meta"):
        model = build_model(json.loads(json.dumps(CFG["program"]["model"])), CFG["vocab_size"])
    assert spec == {n: tuple(p.shape) for n, p in model.named_parameters()}
