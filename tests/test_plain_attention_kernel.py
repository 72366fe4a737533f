"""On the card: the plain ("xla") attention kernel (``csrc/plain_attn.cu``)
against the plain formulation it computes (``xla_attention``), the routing
of ``impl="xla"`` and its counters.  The tests carry the ``card`` marker and
skip without a CUDA card.  This file imports no JAX, so on a card host run
it without the JAX-bound ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_plain_attention_kernel.py

The check is ``plain_attention.agreement``: the kernel keeps the
formulation's rounding points and changes only the order of its f32 sums
(QKᵀ, the softmax denominator, PV), so nearly every output carries the
plain formulation's very bits and none lies more than two bf16 ulps away.
A lost key tile, unnormalised weights (an online softmax) and unrounded
scores each fail it, on the card as on the CPU.
"""

import pytest
import torch

from memvul_tpu_torch.ops import plain_attention as pa
from memvul_tpu_torch.ops.attention import dot_product_attention, mask_to_bias, xla_attention

# the fully masked row's uniform weights bf16(1/T) sum to 1 within bf16's
# 2^-8, so its mean of values of order 1 is held within 1/64
MASKED_ROW_TOL = 1.0 / 64

# [B, T, H]: the base buckets at 262144 tokens, a tensor-parallel rank's
# 6 heads, odd lengths with a partial key tile, and T = 1
SHAPES = [(4096, 64, 12), (2048, 128, 12), (1024, 256, 12), (512, 512, 12), (512, 512, 6),
          (3, 300, 12), (2, 37, 12), (2, 1, 12)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(b, t, h, seed, lengths=None, pad=0):
    """bf16 q, k, v [B, T, H, 64] (views of [..., 64 + pad] when ``pad``),
    N(0, 1), and the padding-mask bias of the given key lengths (random
    lengths by default, with a fully masked row where B > 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, 64 + pad, device="cuda", generator=gen)
               .to(torch.bfloat16)[..., :64] for _ in range(3))
    if lengths is None:
        cpu = torch.Generator().manual_seed(seed)
        lengths = torch.randint(1, t + 1, (b,), generator=cpu).tolist()
        if b > 1:
            lengths[-1] = 0
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
    return q, k, v, mask_to_bias(mask, torch.bfloat16)


@pytest.mark.card
@pytest.mark.parametrize("b,t,h", SHAPES)
def test_kernel_matches_the_plain_formulation(card, b, t, h):
    q, k, v, bias = _inputs(b, t, h, seed=b * t + h)
    before = pa.launches
    got = pa.plain_attention_cuda(q, k, v, bias)
    want = xla_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    stats = pa.agreement(got, want, v)
    assert stats["ok"], stats
    if b > 1:  # the fully masked row averages its values uniformly
        mean = v[-1].float().mean(0, keepdim=True).expand(t, h, 64)
        assert (got[-1].float() - mean).abs().max().item() <= MASKED_ROW_TOL
    if t >= 64:  # the check sees a key tile lost
        lost = bias.clone()
        lost[..., :64] = torch.finfo(torch.bfloat16).min
        assert not pa.agreement(xla_attention(q, k, v, lost), want, v)["ok"]


@pytest.mark.card
@pytest.mark.parametrize("case", ["no_bias", "batch_broadcast_bias", "unaligned_views"])
def test_kernel_variants(card, case):
    q, k, v, bias = _inputs(8, 200, 12, seed=7, pad=4 if case == "unaligned_views" else 0)
    if case == "no_bias":
        bias = None
    elif case == "batch_broadcast_bias":
        bias = bias[:1]
    got = pa.plain_attention_cuda(q, k, v, bias)
    want = xla_attention(q, k, v, bias)
    stats = pa.agreement(got, want, v)
    assert stats["ok"], stats


@pytest.mark.card
@pytest.mark.parametrize("shortcut", ["unnormalised", "f32_scores"])
def test_the_check_fails_a_shortcut_on_the_card(card, shortcut):
    """The formulation with a rounding point dropped, on the card's own
    inputs, fails the check that the kernel passes."""
    from test_torch_plain_attention import formulation

    q, k, v, bias = _inputs(3, 300, 12, seed=5)
    want = xla_attention(q, k, v, bias)
    assert pa.agreement(pa.plain_attention_cuda(q, k, v, bias), want, v)["ok"]
    assert not pa.agreement(formulation(q, k, v, bias, shortcut), want, v)["ok"]


@pytest.mark.card
def test_past_512_keys_the_routing_runs_the_plain_formulation(card):
    q, k, v, bias = _inputs(4, 1024, 12, seed=9)
    with pytest.raises(ValueError, match="1024 keys"):
        pa.plain_attention_cuda(q, k, v, bias)
    launches, on_card = pa.launches, pa.plain_on_card
    got = dot_product_attention(q, k, v, bias=bias, impl="xla")
    assert torch.equal(got, xla_attention(q, k, v, bias))
    assert (pa.launches, pa.plain_on_card) == (launches, on_card + 1)


@pytest.mark.card
def test_routing_and_counters_on_the_card(card):
    q, k, v, bias = _inputs(4, 128, 12, seed=3)
    launches, on_card = pa.launches, pa.plain_on_card
    with torch.no_grad():
        dot_product_attention(q, k, v, bias=bias, impl="xla")
    assert (pa.launches, pa.plain_on_card) == (launches + 1, on_card)
    f32 = [x.float() for x in (q, k, v)]
    dot_product_attention(*f32, bias=bias.float(), impl="xla")
    q.requires_grad_(True)
    dot_product_attention(q, k, v, bias=bias, impl="xla")
    assert (pa.launches, pa.plain_on_card) == (launches + 1, on_card + 2)


@pytest.mark.card
def test_every_encoder_attention_call_launches_the_kernel(card):
    from memvul_tpu_torch.models.bert import BertConfig, BertEncoder

    cfg = BertConfig.tiny(hidden_size=128, num_heads=2, num_layers=3, dtype=torch.bfloat16)
    model = BertEncoder(cfg).to(card).eval()
    ids = torch.randint(0, cfg.vocab_size, (4, 96), device=card)
    mask = torch.ones(4, 96, dtype=torch.int32, device=card)
    mask[1, 40:] = 0
    launches, on_card = pa.launches, pa.plain_on_card
    with torch.no_grad():
        model(ids, mask)
    assert (pa.launches, pa.plain_on_card) == (launches + cfg.num_layers, on_card)
