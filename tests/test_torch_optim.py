"""The port's schedules and grouped AdamW against the JAX package's optax
versions: every schedule equal at steps 0…N (1e-6), and five optimizer
steps on a small parameter tree with groups, clipping, weight decay and a
momentum schedule within 1e-6 of ``make_optimizer``'s optax chain."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from memvul_tpu.training import optim as joptim
from memvul_tpu_torch.training import optim

SCHEDULES = [
    {"type": "constant"},
    {"type": "linear_with_warmup", "warmup_steps": 5},
    {"type": "linear_with_warmup", "warmup_steps": 5, "total_steps": 20},
    {"type": "slanted_triangular", "num_steps": 30, "cut_frac": 0.2, "ratio": 16},
    {"type": "cosine_with_warmup", "warmup_steps": 4, "total_steps": 25},
    {"type": "polynomial_decay", "warmup_steps": 3, "total_steps": 25, "power": 2.0,
     "end_factor": 0.1},
]


def _assert_schedule_equal(mine, want, steps):
    """``mine`` at 0…steps-1 against the JAX schedule, evaluated on the
    whole step range at once."""
    expected = np.broadcast_to(np.asarray(want(jnp.arange(steps))), (steps,))
    np.testing.assert_allclose([mine(s) for s in range(steps)], expected, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec", SCHEDULES, ids=lambda s: s["type"] + str(len(s)))
def test_schedules_match_jax(spec):
    _assert_schedule_equal(optim.make_schedule(spec), joptim.make_schedule(spec), 32)


@pytest.mark.parametrize("warmup,total", [(0, None), (4, None), (4, 12), (0, 10)])
def test_linear_with_warmup_matches_jax(warmup, total):
    _assert_schedule_equal(
        optim.linear_with_warmup(warmup, total), joptim.linear_with_warmup(warmup, total), 16)


@pytest.mark.parametrize("spec", [
    {"type": "constant"},
    {"type": "inverted_triangular", "low": 0.8, "cooldown_steps": 3, "warmup_steps": 4},
])
def test_momentum_schedule_matches_jax(spec):
    _assert_schedule_equal(optim.make_momentum_schedule(spec, base=0.9),
                           joptim.make_momentum_schedule(spec, base=0.9), 12)


def test_unknown_schedule_types_raise_as_in_jax():
    for bad in ({"type": "nope"}, {"type": "cosine_with_warmup"}):
        with pytest.raises(ValueError):
            optim.make_schedule(bad)
    with pytest.raises(ValueError):
        optim.make_momentum_schedule({"type": "nope"})


def test_labels_follow_the_flax_paths():
    labels = optim.label_params(["bert.embeddings.word_embeddings.weight", "pooler.dense.bias",
                                 "header.dense.weight", "pair_kernel"])
    assert labels == {"bert.embeddings.word_embeddings.weight": "embedder",
                      "pooler.dense.bias": "pooler", "header.dense.weight": "default",
                      "pair_kernel": "default"}


SHAPES = {"bert": {"w": (4, 3), "b": (3,)}, "pooler": {"w": (3, 3)}, "header": {"w": (3, 2)},
          "pair_kernel": (6, 2)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


CASES = {
    "warmup_clip_groups": dict(warmup_steps=2, total_steps=8, grad_clip_norm=0.5),
    "no_schedule_no_clip": dict(grad_clip_norm=None, group_lrs={"embedder": 3e-3, "pooler": 2e-3}),
    "decay_and_momentum": dict(
        weight_decay=0.01, grad_clip_norm=1.0, warmup_steps=1,
        momentum_schedule={"type": "inverted_triangular", "low": 0.7, "cooldown_steps": 2,
                           "warmup_steps": 2},
    ),
    "cosine_schedule": dict(
        lr_schedule={"type": "cosine_with_warmup", "warmup_steps": 1, "total_steps": 6},
        grad_clip_norm=2.0, weight_decay=0.1,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_the_optax_chain(case):
    kw = dict(base_lr=1e-2, **CASES[case])
    rng = np.random.default_rng(0)
    flat_shapes = _flat(SHAPES)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in flat_shapes.items()}
    grads = [{n: (rng.standard_normal(s) * 0.7).astype(np.float32) for n, s in flat_shapes.items()}
             for _ in range(5)]

    # the JAX chain, on flax-style paths ("params/bert/w" labels "embedder")
    jparams = {"params": _unflat({n: jnp.asarray(v) for n, v in init.items()})}
    tx, state = joptim.make_optimizer(jparams, **kw)

    @jax.jit
    def update(jg, state, jparams):
        updates, state = tx.update(jg, state, jparams)
        return optax.apply_updates(jparams, updates), state

    for g in grads:
        jg = {"params": _unflat({n: jnp.asarray(v) for n, v in g.items()})}
        jparams, state = update(jg, state, jparams)
    want = _flat(jax.device_get(jparams)["params"])

    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    opt = optim.make_optimizer(params.items(), **kw)
    norms = []
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy())
        norms.append(float(opt.step()))
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)
    for g, norm in zip(grads, norms):
        np.testing.assert_allclose(norm, float(optax.global_norm(g)), rtol=1e-6)
    assert opt.count == 5


def test_first_update_is_scaled_to_zero_by_the_warmup():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.make_optimizer([("header.w", p)], base_lr=0.1, warmup_steps=4)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
    p.grad = torch.ones(3)
    opt.step()
    assert float(p.detach()[0]) < 1.0
