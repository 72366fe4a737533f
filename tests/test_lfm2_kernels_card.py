"""On the card: the LFM2 encoder's kernels against their plain versions,
and its forward without a host sync.  The tests carry the ``card`` marker
and skip without a CUDA card.  This file imports no JAX, so on a card host
run it without the JAX-bound ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_lfm2_kernels_card.py

* K2 causal and grouped (32 query heads over 8 K/V heads) against
  ``flash_attention_reference`` at the LFM2 cell's bucket shapes (262144
  tokens a batch), odd lengths and a partial key tile, at K2's bf16
  tolerance (``chip_smoke.py``'s: atol = rtol = 3e-2 on q, k ~ 2·N(0, 1),
  v ~ N(0, 1)).
* K5 against ``grouped_gemm_reference`` at the cell's routing (262144
  slots, top-4 of 32 experts, widths 2048 / 1792): ``moe.agreement``.  A
  lost reduction slice and a wrong expert offset each fail it.
* A scoring forward of an LFM2 model under ``torch.cuda.set_sync_debug_mode
  ("error")``, with K5 and causal K2 counted from 0.
"""

import math

import pytest
import torch

from memvul_tpu_torch.ops import flash_attention as fa
from memvul_tpu_torch.ops import moe
from memvul_tpu_torch.ops.attention import mask_to_bias
from memvul_tpu_torch.ops.moe import agreement

TOL = 3e-2
BUCKETS = [64, 128, 256, 512, 1024, 2048, 4096]
TOKENS = 262144

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _attention_inputs(b, t, heads, kv_heads, lengths, gen):
    q = (torch.randn(b, t, heads, 64, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    k = (torch.randn(b, t, kv_heads, 64, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    v = torch.randn(b, t, kv_heads, 64, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
    return q, k, v, mask_to_bias(mask, torch.float32)


def _close(got, want, valid=None):
    got, want = got.float(), want.float()
    if valid is not None:
        got, want = got[valid], want[valid]
    diff = (got - want).abs()
    return bool(torch.isfinite(got).all()) and bool((diff <= TOL + TOL * want.abs()).all())


@pytest.mark.card
@pytest.mark.parametrize("t", BUCKETS)
def test_k2_causal_grouped_at_the_cell_buckets(card, t):
    b = TOKENS // t
    gen = torch.Generator(device="cuda").manual_seed(t)
    lengths = torch.randint(1, t + 1, (b,), generator=torch.Generator().manual_seed(t)).tolist()
    q, k, v, bias = _attention_inputs(b, t, 32, 8, lengths, gen)
    fa.causal_launches = 0
    got = fa.flash_attention(q, k, v, bias, causal=True)
    want = fa.flash_attention_reference(q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    assert fa.causal_launches == 1
    assert _close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("b,t,heads,kv_heads,lengths", [
    (3, 300, 32, 8, [300, 173, 1]),   # a partial key tile, padding rows
    (2, 37, 32, 8, [37, 5]),          # one partial tile
    (2, 1, 4, 1, [1, 1]),             # T = 1, all heads on one K/V head
    (2, 577, 12, 12, [577, 400]),     # causal without groups: odd items
    (2, 333, 16, 4, [333, 333]),
])
def test_k2_causal_grouped_odd_shapes(card, b, t, heads, kv_heads, lengths):
    gen = torch.Generator(device="cuda").manual_seed(b * t)
    q, k, v, bias = _attention_inputs(b, t, heads, kv_heads, lengths, gen)
    got = fa.flash_attention(q, k, v, bias, causal=True)
    want = fa.flash_attention_reference(q, k, v, bias, causal=True)
    assert _close(got, want)
    # grouped without the causal mask, on the same inputs
    assert _close(fa.flash_attention(q, k, v, bias), fa.flash_attention_reference(q, k, v, bias))
    # a kernel that read the keys past the diagonal would fail
    if t > 1:
        assert not _close(fa.flash_attention_reference(q, k, v, bias), want)


@pytest.mark.card
def test_k2_causal_f32_cuda_cores(card):
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, bias = _attention_inputs(3, 300, 8, 2, [300, 120, 7], gen)
    q, k, v = q.float(), k.float(), v.float()
    got = fa.flash_attention(q, k, v, bias, causal=True)
    want = fa.flash_attention_reference(q, k, v, bias, causal=True)
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5)


def _routed(slots, gen, experts=32, top_k=4, d=2048):
    x = torch.randn(slots, d, device="cuda", generator=gen).to(torch.bfloat16)
    gate = (torch.randn(experts, d, device="cuda", generator=gen) / math.sqrt(d)).to(torch.bfloat16)
    bias = (torch.randn(experts, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    selected, _ = moe.route(x, gate, bias, top_k)
    order, offsets = moe.dispatch(selected, experts)
    rows = x.index_select(0, torch.div(order, top_k, rounding_mode="floor"))
    return rows, offsets


def _expert_weights(gen, experts=32, d=2048, f=1792):
    w13 = (torch.randn(experts, 2 * f, d, device="cuda", generator=gen) / math.sqrt(d))
    w2 = (torch.randn(experts, d, f, device="cuda", generator=gen) / math.sqrt(f))
    return w13.to(torch.bfloat16), w2.to(torch.bfloat16)


@pytest.mark.card
def test_k5_at_the_cell_routing(card):
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows, offsets = _routed(TOKENS, gen)
    w13, w2 = _expert_weights(gen)
    moe.launches = 0
    hidden = moe.grouped_gemm(rows, w13, offsets, swiglu=True)
    want_hidden = moe.grouped_gemm_reference(rows, w13, offsets, swiglu=True)
    stats = agreement(hidden, want_hidden)
    assert stats["ok"], stats
    out = moe.grouped_gemm(want_hidden, w2, offsets)
    stats = agreement(out, moe.grouped_gemm_reference(want_hidden, w2, offsets, swiglu=False))
    assert stats["ok"], stats
    assert moe.launches == 2


@pytest.mark.card
def test_k5_agreement_catches_a_lost_slice_and_a_wrong_offset(card):
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows, offsets = _routed(16384, gen, experts=8)
    w13, _ = _expert_weights(gen, experts=8)
    want = moe.grouped_gemm_reference(rows, w13, offsets, swiglu=True)
    # one 64-deep slice of the reduction lost in one 128 × 128 output tile
    lost = rows.clone()
    lost[:128, :64] = 0
    bad = want.clone()
    bad[:128, :128] = moe.grouped_gemm(lost, w13, offsets, swiglu=True)[:128, :128]
    assert not agreement(bad, want)["ok"]
    # an expert's first row shifted by one
    shifted = offsets.clone()
    shifted[3] += 1
    assert not agreement(moe.grouped_gemm(rows, w13, shifted, swiglu=True), want)["ok"]
    assert agreement(moe.grouped_gemm(rows, w13, offsets, swiglu=True), want)["ok"]


@pytest.mark.card
def test_lfm2_scoring_forward_has_no_host_sync(card):
    from memvul_tpu_torch.models.lfm2 import Lfm2Config
    from memvul_tpu_torch.models.memory import MemoryModel

    cfg = Lfm2Config.tiny(hidden_size=256, num_heads=4, num_kv_heads=2, intermediate_size=512,
                          moe_intermediate_size=128, num_experts=8, num_experts_per_tok=2,
                          dtype=torch.bfloat16)
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = MemoryModel(cfg).eval()
    ids = torch.randint(0, cfg.vocab_size, (8, 256), device="cuda")
    mask = torch.ones(8, 256, dtype=torch.int32, device="cuda")
    mask[3, 100:] = 0
    with torch.no_grad():
        model.encode(ids, mask)  # the library's build and first launches
        torch.cuda.synchronize()
        moe.launches = 0
        fa.causal_launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            u = model.encode(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(u).all())
    assert moe.launches == 2 * 4  # two K5 products in each of the 4 MoE layers
    assert fa.causal_launches == 2
