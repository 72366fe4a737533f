"""The port's anchor match against the JAX package's: the plain version
against ``fused_anchor_match(interpret=True)`` and
``anchor_match_reference``, at the JAX kernel tests' shapes, in f32 at
1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from memvul_tpu.ops.pallas.anchor_match import (
    anchor_match_reference as jax_reference,
    fused_anchor_match as jax_fused,
)
from memvul_tpu_torch.ops import anchor_match as am

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, a, d, c=2, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d)).astype(np.float32)
    v = rng.normal(size=(a, d)).astype(np.float32)
    kernel = (rng.normal(size=(3 * d, c)) * 0.1).astype(np.float32)
    return u, v, kernel


@pytest.mark.parametrize(
    "b,a,d,c",
    [(4, 6, 32, 2), (9, 13, 40, 2), (17, 129, 200, 2), (130, 5, 96, 2), (5, 7, 64, 3),
     (16, 129, 512, 2)],  # the serve pack: 16 rows against the 129-anchor bank
)
def test_plain_matches_jax(b, a, d, c):
    u, v, kernel = _inputs(b, a, d, c, seed=b + a + d)
    want_fused = np.asarray(jax_fused(jnp.asarray(u), jnp.asarray(v), jnp.asarray(kernel), interpret=True))
    want_ref = np.asarray(jax_reference(jnp.asarray(u), jnp.asarray(v), jnp.asarray(kernel)))
    for impl in (None, "auto", "fused", "xla"):
        got = am.anchor_match(*map(torch.from_numpy, (u, v, kernel)), impl=impl).numpy()
        assert got.shape == (b, a, c)
        np.testing.assert_allclose(got, want_fused, **TOL)
        np.testing.assert_allclose(got, want_ref, **TOL)


def test_plain_matches_naive_concat():
    u, v, kernel = _inputs(6, 5, 24, seed=4)
    feats = [
        np.concatenate([u, np.broadcast_to(v[i], u.shape), np.abs(u - v[i])], axis=-1) @ kernel
        for i in range(v.shape[0])
    ]
    want = np.stack(feats, axis=1)
    got = am.anchor_match_reference(*map(torch.from_numpy, (u, v, kernel))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bf16_plain_close_to_f32():
    u, v, kernel = _inputs(8, 9, 128, seed=3)
    t = [torch.from_numpy(x) for x in (u, v, kernel)]
    got = am.anchor_match(*[x.to(torch.bfloat16) for x in t])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), am.anchor_match_reference(*t).numpy(), atol=3e-1, rtol=3e-2
    )


def test_bad_shapes_and_impls_raise():
    u, v, kernel = map(torch.from_numpy, _inputs(4, 5, 32))
    with pytest.raises(ValueError, match="dimension mismatch"):
        am.anchor_match(u, v, kernel[:-1])
    with pytest.raises(ValueError, match="expected"):
        am.anchor_match(u[None], v, kernel)
    with pytest.raises(ValueError, match="unknown anchor_match impl"):
        am.anchor_match(u, v, kernel, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        am.fused_anchor_match(u, v, kernel)
