"""The port's ring attention (``memvul_tpu_torch.parallel.ring``) on a
4-rank gloo world of CPU processes, held against the JAX package's
``make_ring_attention`` on a ``seq=4`` mesh of its virtual CPU devices,
case for case with ``tests/test_ring_attention.py``: full mask, ragged,
all-masked rows, length mixes on and off the shard boundaries, bf16, the
sequence-parallel encoder, the wrong impl and the gradients.  One world
runs every case (:func:`ring_cases`, one process per rank) and writes
each rank's slices to ``tmp_path``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

N = 4  # ranks of the ring, and the JAX mesh's seq axis
T_MIX = 64
LENGTH_MIXES = [[64, 37, 0, 16], [1, 48, 63, 32], [0, 0, 64, 17], [15, 16, 33, 49],
                [64, 64, 64, 64], [2, 31, 47, 60]]


def _qkv(b=2, t=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=(b, t, h, d)).astype(np.float32)  # noqa: E731
    return mk(), mk(), mk()


def _mask(lengths, t):
    mask = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return mask


def _cases():
    """name → (q, k, v, mask, dtype) over the whole sequence."""
    cases = {}
    q, k, v = _qkv()
    cases["full"] = (q, k, v, np.ones(q.shape[:2], np.int32), "float32")
    q, k, v = _qkv(seed=1)
    cases["ragged"] = (q, k, v, _mask([64, 37], 64), "float32")
    q, k, v = _qkv(seed=3)
    mask = np.ones(q.shape[:2], np.int32)
    mask[1, :] = 0
    cases["all_masked"] = (q, k, v, mask, "float32")
    for i, lengths in enumerate(LENGTH_MIXES):
        q, k, v = _qkv(b=4, t=T_MIX, seed=100 + i)
        cases[f"mix{i}"] = (q, k, v, _mask(lengths, T_MIX), "float32")
    q, k, v = _qkv(seed=2)
    cases["bf16"] = (q, k, v, np.ones(q.shape[:2], np.int32), "bfloat16")
    return cases


def _grad_inputs():
    q, k, v = _qkv(seed=3, t=32, h=2, d=8)
    return q, k, v, _mask([32, 21], 32)


def ring_cases(work_dir: str, encoder_file: str):
    """One rank of the world: every case's local output slice (and the
    gradients, and the encoder's hidden states) into ``work_dir``."""
    torch.set_num_threads(1)
    from memvul_tpu_torch.models.bert import BertConfig, BertEncoder
    from memvul_tpu_torch.parallel import create_mesh, encode_sequence_parallel, make_ring_attention

    mesh = create_mesh({"seq": N}, device="cpu")
    r = mesh.index("seq")
    ring = make_ring_attention(mesh)
    out = {}

    def local(x):
        per = x.shape[1] // N
        return torch.from_numpy(np.ascontiguousarray(x[:, r * per:(r + 1) * per]))

    for name, (q, k, v, mask, dtype) in _cases().items():
        dt = getattr(torch, dtype)
        res = ring(local(q).to(dt), local(k).to(dt), local(v).to(dt), local(mask))
        assert res.dtype == dt
        out[name] = res.to(torch.float32).numpy()
    q, k, v, mask = _grad_inputs()
    tq, tk, tv = (local(x).requires_grad_(True) for x in (q, k, v))
    (ring(tq, tk, tv, local(mask)) ** 2).sum().backward()
    out["dq"], out["dk"], out["dv"] = tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()
    cfg = BertConfig.tiny(vocab_size=512, attention_impl="ring")
    enc = BertEncoder(cfg).eval()
    enc.load_state_dict(torch.load(encoder_file))
    ids, emask = np.load(Path(encoder_file).with_suffix(".npz")).values()
    out["encoder"] = encode_sequence_parallel(
        enc, torch.from_numpy(ids).long(), torch.from_numpy(emask), mesh).numpy()
    errors = []
    for bad_len in (62, 1024):  # not divisible by seq=4; past the position table
        try:
            encode_sequence_parallel(enc, torch.zeros((1, bad_len), dtype=torch.long),
                                     torch.ones((1, bad_len), dtype=torch.int32), mesh)
        except ValueError as e:
            errors.append(str(e))
    np.savez(Path(work_dir) / f"out-{r}.npz", **out)
    return {"rank": r, "errors": errors}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from memvul_tpu.models import BertConfig as JaxBertConfig
    from memvul_tpu.models import BertEncoder as JaxBertEncoder
    from memvul_tpu_torch.models.convert import encoder_from_flax
    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.parallel.launch import run_ranks

    work = tmp_path_factory.mktemp("ring")
    cfg = JaxBertConfig.tiny(vocab_size=512)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 500, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0  # the second sequence ends inside shard 2
    params = JaxBertEncoder(cfg).init(jax.random.PRNGKey(0), ids, mask)
    sd = encoder_from_flax(jax.tree_util.tree_map(np.asarray, params["params"]),
                           BertConfig.tiny(vocab_size=512))
    torch.save(sd, work / "encoder.pt")
    np.savez(work / "encoder.npz", ids=ids, mask=mask)
    results = run_ranks("test_torch_ring:ring_cases", N, work,
                        {"work_dir": str(work), "encoder_file": str(work / "encoder.pt")},
                        timeout_s=120, env={"OMP_NUM_THREADS": "1"},
                        python_path=[Path(__file__).parent])
    outs = [dict(np.load(work / f"out-{r}.npz")) for r in range(N)]
    whole = {key: np.concatenate([o[key] for o in outs], axis=1) for key in outs[0]}
    return {"out": whole, "results": results, "params": params, "ids": ids, "mask": mask}


@pytest.fixture(scope="module")
def jax_ring():
    import jax

    from memvul_tpu.parallel import create_mesh, make_ring_attention

    return jax.jit(make_ring_attention(create_mesh({"seq": N}, devices=jax.devices()[:N])))


def _jax_ref(jax_ring, name):
    import jax.numpy as jnp

    q, k, v, mask, dtype = _cases()[name]
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return np.asarray(jax_ring(*(jnp.asarray(x, dt) for x in (q, k, v)), jnp.asarray(mask)),
                      np.float32), mask


@pytest.mark.parametrize("name", ["full", "ragged", "all_masked"]
                         + [f"mix{i}" for i in range(len(LENGTH_MIXES))])
def test_ring_matches_jax_ring_f32(world, jax_ring, name):
    ref, mask = _jax_ref(jax_ring, name)
    got = world["out"][name]
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], ref[live], atol=1e-5, rtol=1e-5)
    for i in range(mask.shape[0]):
        if not mask[i].any():  # all-masked rows: exact zeros, as JAX's
            np.testing.assert_array_equal(got[i], np.zeros_like(got[i]))
            np.testing.assert_array_equal(ref[i], np.zeros_like(ref[i]))


def test_ring_bf16_matches_jax_and_fp32(world, jax_ring):
    from memvul_tpu.ops.attention import dot_product_attention, mask_to_bias
    import jax.numpy as jnp

    ref, mask = _jax_ref(jax_ring, "bf16")
    got = world["out"]["bf16"]
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)
    q, k, v, _, _ = _cases()["bf16"]
    dense = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  bias=mask_to_bias(jnp.asarray(mask)))
    np.testing.assert_allclose(got, np.asarray(dense), atol=3e-2, rtol=3e-2)


def test_ring_gradients_match_jax(world, jax_ring):
    import jax
    import jax.numpy as jnp

    q, k, v, mask = _grad_inputs()

    def loss(q, k, v):
        return (jax_ring(q, k, v, jnp.asarray(mask)) ** 2).sum()

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for name, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(world["out"][name], np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_sequence_parallel_encoder_matches_jax_dense(world):
    from memvul_tpu.models import BertConfig, BertEncoder

    dense = BertEncoder(BertConfig.tiny(vocab_size=512))
    ref = np.asarray(dense.apply(world["params"], world["ids"], world["mask"], deterministic=True))
    live = world["mask"].astype(bool)
    np.testing.assert_allclose(world["out"]["encoder"][live], ref[live], atol=1e-5, rtol=1e-5)


def test_sequence_parallel_length_errors(world):
    for res in world["results"]:
        assert len(res["errors"]) == 2
        assert "not divisible by seq=4" in res["errors"][0]
        assert "exceeds max_position_embeddings" in res["errors"][1]


def test_sequence_parallel_rejects_wrong_impl():
    from memvul_tpu_torch.models.bert import BertConfig, BertEncoder
    from memvul_tpu_torch.parallel import encode_sequence_parallel

    enc = BertEncoder(BertConfig.tiny(vocab_size=64))
    with pytest.raises(ValueError, match="ring"):
        encode_sequence_parallel(enc, torch.zeros((1, 64), dtype=torch.long),
                                 torch.ones((1, 64), dtype=torch.int32), mesh=None)


def test_ring_impl_refuses_dropout_and_an_unbound_group():
    from memvul_tpu_torch.ops.attention import dot_product_attention

    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="dropout"):
        dot_product_attention(q, q, q, impl="ring", dropout_rate=0.1, training=True)
    with pytest.raises(RuntimeError, match="encode_sequence_parallel"):
        dot_product_attention(q, q, q, impl="ring")


def test_ring_refuses_a_query_dependent_bias():
    from memvul_tpu_torch.parallel import ring_attention

    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="key-only bias"):
        ring_attention(q, q, q, key_bias=torch.zeros((1, 2, 8, 8)))


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
