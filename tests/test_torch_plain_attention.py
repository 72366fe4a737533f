"""The plain ("xla") attention's kernel route on the CPU: the routing
predicate (every case the kernel does not take goes to the plain
formulation), the wrapper's refusals (it raises, it never falls back), the
host-side score divisor, the plain formulation's bits unchanged by the
divisor's move to the host, and the power of ``plain_attention.agreement``,
the check that holds the kernel to the formulation.  The kernel itself runs
on the card only (``tests/test_plain_attention_kernel.py``)."""

import pytest
import torch

from memvul_tpu_torch.ops import plain_attention as pa
from memvul_tpu_torch.ops.attention import dot_product_attention, mask_to_bias, xla_attention

BF16 = torch.bfloat16


def _qkv(b=2, t=24, h=3, d=64, dtype=BF16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, t, h, d, generator=gen).to(dtype) for _ in range(3))


def _bias(b=2, t=24, dtype=BF16):
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[1, t // 3:] = 0
    return mask_to_bias(mask, dtype)


def test_kernel_takes_the_main_path_call_but_for_its_device():
    """bf16 at head dim 64 with the encoder's key-only bias (or none, or a
    bias broadcast over the batch) fails only on the device here."""
    q, k, v = _qkv()
    for bias in (_bias(), None, _bias()[:1]):
        assert pa.refusal(q, k, v, bias) == "not CUDA tensors on one device"
        assert not pa.kernel_takes(q, k, v, bias)


@pytest.mark.parametrize(
    "case,expect",
    [
        ("f32", "not bf16"),
        ("f32_bias", "not bf16"),
        ("head_dim_16", "head dim 16"),
        ("head_dim_32", "head dim 32"),
        ("long_keys", "576 keys"),
        ("structured_bias", "not key-only"),
        ("head_bias", "not key-only"),
        ("dropout", "attention dropout"),
        ("grad", "gradient"),
        ("grad_bias", "gradient"),
    ],
)
def test_routing_sends_each_excluded_case_to_the_plain_path(case, expect):
    q, k, v = _qkv()
    bias, rate = _bias(), 0.0
    if case == "f32":
        q, k, v = (x.float() for x in (q, k, v))
        bias = _bias(dtype=torch.float32)
    elif case == "f32_bias":  # bf16 scores plus an f32 bias promote to f32
        bias = _bias(dtype=torch.float32)
    elif case.startswith("head_dim"):
        q, k, v = _qkv(d=int(case.rsplit("_", 1)[1]))
    elif case == "long_keys":  # past 512 keys the scores leave shared memory
        q, k, v = _qkv(t=576)
        bias = _bias(t=576)
    elif case == "structured_bias":
        bias = torch.zeros(2, 1, 24, 24, dtype=BF16)
    elif case == "head_bias":
        bias = torch.zeros(2, 3, 1, 24, dtype=BF16)
    elif case == "dropout":
        rate = 0.1
    elif case == "grad":
        q.requires_grad_(True)
    elif case == "grad_bias":
        bias.requires_grad_(True)
    reason = pa.refusal(q, k, v, bias, rate)
    assert reason is not None and expect in reason
    assert not pa.kernel_takes(q, k, v, bias, rate)


def test_no_grad_lifts_the_gradient_refusal():
    q, k, v = _qkv()
    q.requires_grad_(True)
    assert "gradient" in pa.refusal(q, k, v)
    with torch.no_grad():
        assert pa.refusal(q, k, v) == "not CUDA tensors on one device"


@pytest.mark.parametrize(
    "case,expect",
    [
        ("cpu", "not CUDA tensors"),
        ("f32", "not bf16"),
        ("head_dim_32", "head dim 32"),
        ("long_keys", "1024 keys"),
        ("structured_bias", "not key-only"),
        ("grad", "gradient"),
        ("kv_disagree", "disagree"),
    ],
)
def test_the_wrapper_refuses_what_it_cannot_take(case, expect):
    """The launch wrapper raises (it never computes the plain formulation
    instead), and counts no launch."""
    q, k, v = _qkv()
    bias = _bias()
    if case == "f32":
        q, k, v = (x.float() for x in (q, k, v))
    elif case == "head_dim_32":
        q, k, v = _qkv(d=32)
    elif case == "long_keys":
        q, k, v = _qkv(t=1024)
        bias = _bias(t=1024)
    elif case == "structured_bias":
        bias = torch.zeros(2, 1, 24, 24, dtype=BF16)
    elif case == "grad":
        k.requires_grad_(True)
    elif case == "kv_disagree":
        k, v = _qkv(h=2)[:2]
    before = pa.launches
    with pytest.raises(ValueError, match=expect):
        pa.plain_attention_cuda(q, k, v, bias)
    assert pa.launches == before


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("depth", [16, 32, 64])
def test_host_divisor_has_the_device_scales_bits(depth, dtype):
    """The divisor computed on the host is the bits the formulation used to
    compute as ``torch.sqrt(torch.tensor(depth, dtype))``."""
    want = torch.sqrt(torch.tensor(depth, dtype=dtype))
    got = torch.full((), pa.score_divisor(depth, dtype), dtype=dtype)
    assert got.view(torch.int16 if dtype == BF16 else torch.int32) == want.view(
        torch.int16 if dtype == BF16 else torch.int32)
    if depth == 64:  # the kernel's head dim: a power of two, so 1/d is exact
        assert pa.score_divisor(depth, dtype) == 8.0


def _old_xla_attention(query, key, value, bias):
    """The formulation as it was, with the divisor made as a tensor."""
    depth = query.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", query, key) / torch.sqrt(
        torch.tensor(depth, dtype=query.dtype, device=query.device)
    )
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, value)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("depth", [16, 32, 64])
def test_plain_formulation_keeps_its_bits(depth, dtype):
    q, k, v = _qkv(d=depth, dtype=dtype, seed=depth)
    for bias in (_bias(dtype=dtype), None):
        got = xla_attention(q, k, v, bias)
        want = _old_xla_attention(q, k, v, bias)
        assert torch.equal(got, want)


def test_cpu_calls_take_the_plain_path_and_count_nothing():
    """On the CPU ``impl="xla"`` runs the plain formulation; the counters
    are of the card alone."""
    q, k, v = _qkv()
    bias = _bias()
    launches, on_card = pa.launches, pa.plain_on_card
    got = dot_product_attention(q, k, v, bias=bias, impl="xla")
    assert torch.equal(got, xla_attention(q, k, v, bias))
    assert (pa.launches, pa.plain_on_card) == (launches, on_card)


def test_routing_launches_the_kernel_where_the_predicate_holds(monkeypatch):
    """``dot_product_attention`` hands a call the predicate takes to the
    wrapper unchanged, and counts a card call it does not take as
    ``plain_on_card``; the dispatch reads the predicate, never a failure."""
    q, k, v = _qkv()
    bias = _bias()
    seen = []
    monkeypatch.setattr(pa, "kernel_takes", lambda *args: True)
    monkeypatch.setattr(pa, "launch_taken", lambda *args: seen.append(args) or "kernel")
    assert dot_product_attention(q, k, v, bias=bias, impl="xla") == "kernel"
    assert seen[0][0] is q and seen[0][3] is bias
    # dropout while training: the predicate sees the rate that applies
    rates = []
    monkeypatch.setattr(pa, "kernel_takes", lambda *args: rates.append(args[4]) or False)
    dot_product_attention(q, k, v, bias=bias, impl="xla", dropout_rate=0.1, training=True,
                          generator=torch.Generator().manual_seed(0))
    dot_product_attention(q, k, v, bias=bias, impl="xla", dropout_rate=0.1, training=False)
    assert rates == [0.1, 0.0]


def test_tma_ready_views():
    """Views of a projection's output go to the kernel as they are; a view
    whose rows are not 16-byte multiples is copied first."""
    proj = torch.zeros(2, 24, 3 * 64, dtype=BF16)
    assert pa._tma_ready(proj.view(2, 24, 3, 64))
    padded = torch.zeros(2, 24, 3, 68, dtype=BF16)[..., :64]
    assert not pa._tma_ready(padded)
    flat = torch.zeros(2 * 24 * 3 * 64 + 1, dtype=BF16)
    assert not pa._tma_ready(flat[1:].view(2, 24, 3, 64))


def test_only_xla_calls_count_as_kept_off_the_kernel(monkeypatch):
    """``plain_on_card`` counts ``impl="xla"`` calls the routing sent to the
    plain path; a ``"flash"`` call with attention dropout, which runs the
    same formulation, is not one."""
    q, k, v = _qkv()
    counted = []
    monkeypatch.setattr(pa, "count_plain_on_card", counted.append)
    for impl in ("flash", "xla"):
        dot_product_attention(q, k, v, bias=_bias(), impl=impl, dropout_rate=0.1, training=True,
                              generator=torch.Generator().manual_seed(0))
    assert len(counted) == 1 and counted[0] is q


def formulation(q, k, v, bias, shortcut=None):
    """The formulation's rounding points with f32 sums in another order than
    the einsum's, as the kernel computes it; ``shortcut`` drops one of them
    as a kernel might be tempted to: ``"unnormalised"`` rounds exp(s - max)
    to bf16 before the division by the sum (an online softmax),
    ``"f32_scores"`` never rounds the scores."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if shortcut != "f32_scores":
        s = s.to(BF16)
    s = s / pa.score_divisor(q.shape[-1], q.dtype)
    if shortcut != "f32_scores":
        s = s.to(BF16)
    if bias is not None:
        s = s + bias
    e = torch.exp(s.float() - s.float().amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    if shortcut == "unnormalised":
        o = torch.einsum("bhqk,bkhd->bqhd", e.to(BF16).float(), v.float())
        return (o / total.permute(0, 2, 1, 3)).to(BF16)
    w = (e / total).to(BF16).float()
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(BF16)


def _padded(b, t, h, seed):
    """N(0, 1) bf16 q, k, v and a padding bias of random key lengths with a
    fully masked row."""
    q, k, v = _qkv(b=b, t=t, h=h, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=gen).tolist()
    lengths[-1] = 0
    mask = torch.ones(b, t, dtype=torch.int32)
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
    return q, k, v, mask_to_bias(mask, BF16)


@pytest.mark.parametrize("b,t,h", [(4, 256, 4), (2, 512, 2)])
@pytest.mark.parametrize("fault", [None, "unnormalised", "f32_scores", "lost_tile"])
def test_the_check_passes_another_order_and_fails_each_fault(b, t, h, fault):
    """Another order of the f32 sums passes ``agreement``; unnormalised
    weights, unrounded scores or a lost key tile fail it."""
    q, k, v, bias = _padded(b, t, h, seed=b * t)
    want = xla_attention(q, k, v, bias)
    if fault == "lost_tile":
        lost = bias.clone()
        lost[..., :64] = torch.finfo(BF16).min
        got = formulation(q, k, v, lost)
    else:
        got = formulation(q, k, v, bias, fault)
    stats = pa.agreement(got, want, v)
    assert stats["ok"] == (fault is None), stats
