"""The port's attention against the JAX package's: the flash kernel's
plain version against the Pallas ``flash_attention`` (interpret mode) and
``_xla_attention``, and ``impl="xla"`` against ``_xla_attention``, in f32
at the flash kernel tests' tolerance (2e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from memvul_tpu.ops.attention import _xla_attention, mask_to_bias as jax_mask_to_bias
from memvul_tpu.ops.pallas.flash_kernel import flash_attention as jax_flash
from memvul_tpu_torch.ops import flash_attention as fa
from memvul_tpu_torch.ops.attention import dot_product_attention, mask_to_bias

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, t, h, d, seed, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) * 0.5 for _ in range(3))
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
    return q, k, v, mask


def _jax_ref(q, k, v, mask):
    bias = jax_mask_to_bias(jnp.asarray(mask))
    return np.asarray(_xla_attention(q, k, v, bias, None, 0.0, True)), bias


@pytest.mark.parametrize(
    "b,t,h,d,lengths",
    [
        (2, 37, 4, 16, [37, 11]),          # odd T, padded keys
        (3, 300, 2, 64, [300, 173, 0]),    # odd T, one fully masked row
        (2, 256, 4, 32, [256, 256]),       # no padding
    ],
)
def test_flash_reference_matches_jax(b, t, h, d, lengths):
    q, k, v, mask = _inputs(b, t, h, d, seed=t + d, lengths=lengths)
    want_xla, bias = _jax_ref(q, k, v, mask)
    want_flash = np.asarray(jax_flash(q, k, v, bias, interpret=True))
    port_bias = mask_to_bias(torch.from_numpy(mask))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa.flash_attention(tq, tk, tv, port_bias).numpy()
    np.testing.assert_allclose(got, want_flash, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)
    # query chunking changes nothing: a tiny score budget forces one-row chunks
    chunked = fa.flash_attention_reference(tq, tk, tv, port_bias, max_score_bytes=1).numpy()
    np.testing.assert_allclose(chunked, got, **TOL)
    if 0 in lengths:  # a dead row averages its values uniformly, no NaN
        row = lengths.index(0)
        np.testing.assert_allclose(got[row], np.broadcast_to(v[row].mean(0), got[row].shape), **TOL)


@pytest.mark.parametrize("t", [37, 300])
def test_xla_impl_matches_jax(t):
    q, k, v, mask = _inputs(2, t, 4, 16, seed=t, lengths=[t, t // 3])
    want, _ = _jax_ref(q, k, v, mask)
    got = dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), bias=mask_to_bias(torch.from_numpy(mask)), impl="xla"
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_without_bias_matches_jax():
    q, k, v, _ = _inputs(2, 64, 2, 16, seed=5, lengths=[])
    want = np.asarray(jax_flash(q, k, v, interpret=True))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mask_to_bias_matches_jax():
    mask = np.array([[1, 1, 0], [0, 1, 1]], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_mask_to_bias(jnp.asarray(mask), dtype=jdt), np.float32)
        got = mask_to_bias(torch.from_numpy(mask), tdt)
        assert got.dtype == tdt and got.shape == (2, 1, 1, 3)
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.isfinite(got).all()


def test_flash_bf16_reference_close_to_f32():
    q, k, v, mask = _inputs(2, 64, 2, 32, seed=9, lengths=[64, 40])
    bias32 = mask_to_bias(torch.from_numpy(mask))
    t32 = [torch.from_numpy(x) for x in (q, k, v)]
    want = fa.flash_attention(*t32, bias32)
    got = fa.flash_attention(
        *[x.to(torch.bfloat16) for x in t32], mask_to_bias(torch.from_numpy(mask), torch.bfloat16)
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2, rtol=3e-2)


def test_structured_bias_and_ragged_path_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(fa.UnsupportedBiasError):
        fa.flash_attention(q, q, q, torch.zeros(1, 2, 8, 8))
    # segment_ids route to the ragged kernel, which refuses ids that are
    # not [B, T] of the queries
    with pytest.raises(ValueError, match="segment_ids"):
        dot_product_attention(q, q, q, segment_ids=torch.ones(1, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, q, q, impl="dense")


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_cuda(q, q, q, torch.zeros(1, 8))
