"""K2 under autograd and one optimizer step against the JAX package, in
f32 on the CPU:

* ``FlashAttentionFunction`` (its forward injected with the plain version,
  as the CPU has no kernel) against ``jax.vjp`` of the JAX
  ``flash_attention`` in interpret mode: output and dq/dk/dv within 1e-5;
* one train step of the tiny model against the JAX ``make_train_step`` on
  the same carried weights and the same stacks (dropout 0, no warmup, so
  the update is not scaled to zero), dead microbatches and the dedup
  gather included: loss, grad norm, confusion and the updated weights
  within 1e-5;
* dropout: the same generator seed gives the same bits, eval mode is the
  identity, and the packed path refuses dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.ops.pallas.flash_kernel import flash_attention as jax_flash
from memvul_tpu.training.optim import make_optimizer as jax_make_optimizer
from memvul_tpu.training.trainer import make_train_step
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel
from memvul_tpu_torch.ops import attention as pattn
from memvul_tpu_torch.ops import flash_attention as fa
from memvul_tpu_torch.training.optim import make_optimizer
from memvul_tpu_torch.training.trainer import MemoryTrainer, TrainerConfig, train_step

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _qkv(seed, b=2, t=40, h=2, d=16, lengths=(40, 23)):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) * s for s in (1.5, 1.5, 1.0))
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
    bias = np.where(mask[:, None, None, :] > 0, 0.0, np.finfo(np.float32).min).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    return q, k, v, bias, g


@pytest.mark.parametrize("seed,lengths", [(0, (40, 23)), (1, (40, 0)), (2, (7, 40))])
def test_flash_function_grads_match_jax_vjp(seed, lengths):
    q, k, v, bias, g = _qkv(seed, lengths=lengths)
    out_j, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, jnp.asarray(bias), interpret=True),
                         *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kb = fa.key_bias(torch.from_numpy(bias), 2, q.shape[1], "cpu")
    out = fa.FlashAttentionFunction.apply(tq, tk, tv, kb, fa._reference_forward)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for mine, want in zip(grads, grads_j):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), **TOL)
    # the public entry point takes the same Function under a gradient
    via_entry = fa.flash_attention(tq, tk, tv, torch.from_numpy(bias))
    assert type(via_entry.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert fa.flash_attention(tq, tk, tv, torch.from_numpy(bias)).grad_fn is None


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("tstep"), seed=5)


def _stacks(ws, tmp_path, dedup, buckets):
    """Host stacks of the port trainer's collation (tiny geometry)."""
    tok = WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    model = MemoryModel(BertConfig.tiny(vocab_size=tok.vocab_size, hidden_dropout=0.0,
                                        attention_dropout=0.0), header_dim=32)
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"],
                          same_diff_ratio={"same": 3, "diff": 3}, sample_neg=0.5, seed=1)
    trainer = MemoryTrainer(
        model, tok, reader, ws["paths"]["train"],
        config=TrainerConfig(batch_size=4, grad_accum=3, max_length=48, train_buckets=buckets,
                             dedup_anchors=dedup, warmup_steps=0),
        device="cpu",
    )
    return [s for s, _ in trainer._microbatch_stacks()]


def _pick(stacks, dedup):
    """A stack whose last microbatch is dead (zero weight, as the
    trainer's tail padding makes it) and, with dedup, whose gather repeats
    rows."""
    stack = next(s for s in stacks if not dedup
                 or len(np.unique(s["sample2_index"][0])) < s["label"].shape[1])
    stack = {k: ({kk: vv.copy() for kk, vv in v.items()} if isinstance(v, dict) else v.copy())
             for k, v in stack.items()}
    stack["weight"][-1] = 0.0
    return stack


@pytest.mark.parametrize("impl,dedup,buckets", [
    ("xla", True, "pow2"), ("flash", True, "pow2"), ("flash", False, None),
])
def test_train_step_matches_jax(ws, tmp_path, impl, dedup, buckets):
    stacks = _stacks(ws, tmp_path, dedup, buckets)
    stack = _pick(stacks, dedup)
    if dedup:
        assert "sample2_index" in stack
    vocab = int(ws["tokenizer"].vocab_size)
    kw = dict(vocab_size=vocab, hidden_dropout=0.0, attention_dropout=0.0, attention_impl=impl)
    jmodel = JaxMemoryModel(JaxBertConfig.tiny(**kw), header_dim=32)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), dummy, dummy))
    host = jax.tree_util.tree_map(np.array, params)
    opt_kw = dict(base_lr=1e-3, warmup_steps=0, grad_clip_norm=1.0, weight_decay=0.01,
                  group_lrs={"embedder": 5e-4, "pooler": 7e-4})
    tx, opt_state = jax_make_optimizer(params, **opt_kw)
    step = jax.jit(make_train_step(jmodel, tx))
    new_params, _, _, stats = step(params, opt_state, jax.random.PRNGKey(0), stack)
    new_params = jax.device_get(new_params)

    pcfg = BertConfig.tiny(**kw)
    pmodel = MemoryModel(pcfg, header_dim=32)
    pmodel.load_state_dict(params_from_flax(host, pcfg))
    pmodel.train()
    opt = make_optimizer(pmodel.named_parameters(), **opt_kw)
    tstack = {k: ({kk: torch.from_numpy(vv).long() for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in stack.items()}
    got = train_step(pmodel, opt, tstack, torch.Generator().manual_seed(0))

    np.testing.assert_allclose(float(got["loss"]), float(stats["loss"]), **TOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(stats["grad_norm"]), **TOL)
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(stats["confusion"]))
    want = params_from_flax(new_params, pcfg)
    for name, value in pmodel.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **TOL)


def _dropout_model(impl="xla"):
    torch.manual_seed(0)
    cfg = BertConfig.tiny(vocab_size=64, attention_impl=impl, hidden_dropout=0.2,
                          attention_dropout=0.3)
    return MemoryModel(cfg, header_dim=16)


def _sample(seed=0):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(5, 64, size=(3, 12)))
    mask = torch.ones_like(ids)
    mask[2, 7:] = 0
    return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dropout_same_seed_same_bits_and_eval_is_identity(impl):
    model = _dropout_model(impl)
    s1, s2 = _sample(0), _sample(1)
    model.train()
    a = model(s1, s2, generator=torch.Generator().manual_seed(9))
    b = model(s1, s2, generator=torch.Generator().manual_seed(9))
    c = model(s1, s2, generator=torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    with torch.no_grad():
        e1 = model(s1, s2, generator=torch.Generator().manual_seed(9))
        e2 = model(s1, s2)
    assert torch.equal(e1, e2)
    zero = MemoryModel(model.config.replace(hidden_dropout=0.0, attention_dropout=0.0),
                       header_dim=16)
    zero.load_state_dict(model.state_dict())
    zero.train()
    assert torch.equal(zero(s1, s2).detach(), e1)


def test_flash_with_attention_dropout_trains_through_xla_and_packed_refuses():
    q = torch.randn(1, 6, 2, 16)
    bias = torch.zeros(1, 1, 1, 6)
    calls = []
    original = pattn.flash_attention
    try:
        pattn.flash_attention = lambda *a, **k: calls.append(1) or original(*a, **k)
        pattn.dot_product_attention(q, q, q, bias, impl="flash", dropout_rate=0.1, training=True,
                                    generator=torch.Generator().manual_seed(0))
        assert calls == []
        pattn.dot_product_attention(q, q, q, bias, impl="flash", dropout_rate=0.1, training=False)
        assert calls == [1]
    finally:
        pattn.flash_attention = original
    with pytest.raises(ValueError, match="inference path"):
        pattn.dot_product_attention(q, q, q, impl="flash", dropout_rate=0.1, training=True,
                                    segment_ids=torch.ones(1, 6, dtype=torch.int32))


def test_dedup_gather_scatter_adds_its_gradient():
    model = _dropout_model().eval()
    s1 = _sample(0)
    s2 = {k: v[:2] for k, v in _sample(1).items()}
    index = torch.tensor([1, 0, 1])
    full = {k: v.index_select(0, index) for k, v in s2.items()}
    a = model(s1, s2, sample2_index=index)
    b = model(s1, full)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-6)
    ga = torch.autograd.grad(a.sum(), model.pair_kernel)[0]
    gb = torch.autograd.grad(b.sum(), model.pair_kernel)[0]
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5, atol=1e-6)
