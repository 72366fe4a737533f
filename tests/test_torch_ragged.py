"""The port's ragged (packed) path against the JAX package's: the
segment-masked attention's plain version against the Pallas
``ragged_flash_attention`` (interpret mode) at its tests' tolerance (2e-5;
bf16 against an f32 reference within 3e-2), the packer and page table
array for array, the hypothesis packer properties, and ``encode_ragged``
on carried weights (rtol 2e-4 / atol 2e-5, and within 1e-6 of the port's
own padded embedding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from memvul_tpu.data import batching as jax_batching
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.ops.pallas.ragged_attention import ragged_flash_attention as jax_ragged
from memvul_tpu.ops.pallas.ragged_attention import segment_bias as jax_segment_bias
from memvul_tpu_torch.data import batching
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel
from memvul_tpu_torch.ops import ragged_attention as ra
from memvul_tpu_torch.ops.attention import dot_product_attention

TOL = dict(atol=2e-5, rtol=2e-5)
ENC_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from many intra-op threads, and the test
    workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_segments(rng, t, n_rows, batch=1):
    """The JAX tests' pack layout: rows end to end, 0-padded tail."""
    seg = np.zeros((batch, t), np.int32)
    for b in range(batch):
        offset = 0
        for i in range(n_rows):
            n = int(rng.integers(1, max(2, t // n_rows)))
            if offset + n > t:
                break
            seg[b, offset : offset + n] = i + 1
            offset += n
    return seg


def _qkv(rng, shape):
    return [(rng.normal(size=shape) * 0.5).astype(np.float32) for _ in range(3)]


# -- segment-masked attention -------------------------------------------------


@pytest.mark.parametrize("t", [128, 160])  # 160: not a tile multiple
def test_ragged_reference_matches_jax_kernel(t):
    rng = np.random.default_rng(t)
    b, h, d = 2, 4, 32
    q, k, v = _qkv(rng, (b, t, h, d))
    seg = _random_segments(rng, t, n_rows=5, batch=b)
    want = np.asarray(jax_ragged(q, k, v, jnp.asarray(seg), block_q=128, block_k=128, interpret=True))
    got = ra.ragged_flash_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(seg)).numpy()
    live = seg > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.isfinite(got).all()
    # query chunking changes nothing: a tiny score budget forces one-row chunks
    chunked = ra.ragged_flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(seg), max_score_bytes=1
    ).numpy()
    np.testing.assert_allclose(chunked, got, **TOL)


def test_ragged_reference_any_id_order_matches_jax():
    """Ids in no order and with gaps (an aliased pack skips ids): only
    equality matters."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, (1, 96, 2, 16))
    seg = np.repeat(np.array([7, 0, 2, 7, 9, 2], np.int32), 16)[None]
    want = np.asarray(jax_ragged(q, k, v, jnp.asarray(seg), interpret=True))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), segment_ids=torch.from_numpy(seg)).numpy()
    live = seg > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)


def test_ragged_bf16_close_to_f32_reference():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, (1, 128, 2, 32))
    seg = torch.from_numpy(_random_segments(rng, 128, n_rows=4))
    t32 = [torch.from_numpy(x) for x in (q, k, v)]
    want = ra.ragged_flash_attention(*t32, seg)
    got = ra.ragged_flash_attention(*[x.to(torch.bfloat16) for x in t32], seg)
    assert got.dtype == torch.bfloat16
    live = seg.numpy() > 0
    np.testing.assert_allclose(got.float().numpy()[live], want.numpy()[live], atol=3e-2, rtol=3e-2)


def test_segment_bias_matches_jax():
    seg = np.array([[1, 1, 2, 0]], np.int32)
    want = np.asarray(jax_segment_bias(jnp.asarray(seg)))
    got = ra.segment_bias(torch.from_numpy(seg))
    assert got.shape == (1, 1, 4, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    neg = np.finfo(np.float32).min
    b = got.numpy()[0, 0]
    assert b[0, 1] == 0.0 and b[2, 2] == 0.0
    assert b[0, 2] == neg and (b[:, 3] == neg).all() and (b[3, :] == neg).all()


def test_ragged_rejects_bad_segment_shape():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="segment_ids"):
        ra.ragged_flash_attention(q, q, q, torch.zeros(1, 32, dtype=torch.int32))
    with pytest.raises(ValueError, match="segment_ids"):
        dot_product_attention(q, q, q, segment_ids=torch.zeros(2, 64, dtype=torch.int32))


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ra.ragged_flash_attention_cuda(q, q, q, torch.ones(1, 8, dtype=torch.int32))
    before = ra.launches
    ra.ragged_flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.int32))
    assert ra.launches == before  # the CPU path launches nothing


def test_packed_segments_pass_through_on_cpu():
    """``pack_segments`` builds the card's tile table once per pack; on the
    CPU it only wraps the ids, and both forms give the same attention."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, 2, 16), dtype=np.float32))
               for _ in range(3))
    seg = torch.from_numpy(np.repeat(np.array([[1, 2, 0]], np.int32), 32, axis=1))
    packed = ra.pack_segments(seg)
    assert packed.ids is seg and packed.tile_ranges is None
    assert ra.pack_segments(packed) is packed
    torch.testing.assert_close(ra.ragged_flash_attention(q, k, v, packed),
                               ra.ragged_flash_attention(q, k, v, seg), rtol=0, atol=0)


# -- packing ------------------------------------------------------------------


def _assert_same_sample(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize("seed", range(3))
def test_pack_and_collate_match_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 70, size=40).tolist()
    budget, rows = 96, 8
    packs = batching.pack_token_budget(lengths, budget, rows)
    assert packs == jax_batching.pack_token_budget(lengths, budget, rows)
    for pack in packs:
        seqs = [list(rng.integers(5, 300, size=lengths[i])) for i in pack]
        _assert_same_sample(
            batching.collate_ragged(seqs, budget, rows, pad_id=0),
            jax_batching.collate_ragged(seqs, budget, rows, pad_id=0),
        )


@pytest.mark.parametrize("share", [False, True], ids=["plain", "share_prefixes"])
def test_slot_allocator_matches_jax_across_resets(share):
    rng = np.random.default_rng(7)
    pool = [list(rng.integers(5, 300, size=int(n))) for n in rng.integers(1, 40, size=6)]
    mine = batching.PackSlotAllocator(80, 5, pad_id=0, share_prefixes=share)
    ref = jax_batching.PackSlotAllocator(80, 5, pad_id=0, share_prefixes=share)
    for _ in range(4):  # four packs through the same pages
        for _ in range(7):
            seq = pool[int(rng.integers(len(pool)))]
            assert mine.fits(seq) == ref.fits(seq)
            assert mine.admit(seq) == ref.admit(seq)
        _assert_same_sample(mine.sample(), ref.sample())
        assert mine.real_tokens == ref.real_tokens
        mine.reset()
        ref.reset()
    for attr in ("slots_reused", "rows_aliased", "tokens_aliased"):
        assert getattr(mine, attr) == getattr(ref, attr)
    if share:
        assert mine.rows_aliased > 0


def test_pack_validation():
    with pytest.raises(ValueError, match="token_budget"):
        batching.pack_token_budget([1], 0, 8)
    with pytest.raises(ValueError, match="max_rows"):
        batching.pack_token_budget([1], 96, 0)
    with pytest.raises(ValueError, match="max_rows"):
        batching.collate_ragged([[1]] * 3, 96, 2, pad_id=0)
    with pytest.raises(ValueError, match="overflows token_budget"):
        batching.collate_ragged([[1] * 50, [2] * 50], 96, 8, pad_id=0)


def test_packer_properties_hypothesis():
    """The JAX package's packer properties, held by the port: a partition
    in order, caps kept, sealed packs a pure function of their prefix, and
    collation invariant to trailing dead rows."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=80, deadline=None)
    @given(
        st.lists(st.integers(min_value=1, max_value=64), max_size=40),
        st.integers(min_value=8, max_value=96),
        st.integers(min_value=1, max_value=12),
    )
    def check(lengths, budget, max_rows):
        packs = batching.pack_token_budget(lengths, budget, max_rows)
        assert [i for pack in packs for i in pack] == list(range(len(lengths)))
        for pack in packs:
            assert len(pack) <= max_rows
            assert sum(min(lengths[i], budget) for i in pack) <= budget
        if len(packs) > 1:
            prefix = [i for pack in packs[:-1] for i in pack]
            assert batching.pack_token_budget([lengths[i] for i in prefix], budget, max_rows) == packs[:-1]
        if packs and len(packs[0]) < max_rows:
            seqs = [[1] * lengths[i] for i in packs[0]]
            a = batching.collate_ragged(seqs, budget, max_rows, pad_id=0)
            b = batching.collate_ragged(seqs, budget, max_rows + 3, pad_id=0)
            for key in ("input_ids", "attention_mask", "segment_ids", "position_ids"):
                np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a["row_starts"][: len(seqs)], b["row_starts"][: len(seqs)])

    check()


def _loop_tile_ranges(seg):
    """The range table by a Python loop over positions."""
    b, t = seg.shape
    n = -(-t // ra.TILE)
    want = np.zeros((b, n, 2), np.int64)
    want[..., 0] = np.iinfo(np.int32).max
    for i in range(b):
        for j in range(t):
            s = int(seg[i, j])
            if s > 0:
                tile = want[i, j // ra.TILE]
                tile[0], tile[1] = min(tile[0], s), max(tile[1], s)
    return want


@pytest.mark.parametrize("t", [1, 64, 200])
def test_tile_ranges_reference_matches_a_loop(t):
    rng = np.random.default_rng(t)
    seg = rng.choice(np.array([0, 0, 2, 3, 7, 11], np.int32), size=(2, t))
    seg[1, : t // 2] = 0  # a tile with no live id (when t ≥ 128)
    got = ra.tile_ranges_reference(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _loop_tile_ranges(seg))


@pytest.mark.parametrize("key_tile", [64, 128])
def test_visit_lists_cover_every_visible_pair_hypothesis(key_tile):
    """Every (query, key) pair that attention lets through has its key tile
    in its query tile's visit list, for the packer's layouts and for ids in
    no order with gaps; a query tile without a live id visits nothing."""
    from hypothesis import given, settings, strategies as st

    runs = st.lists(st.tuples(st.integers(min_value=1, max_value=150),
                              st.sampled_from([0, 1, 2, 3, 5, 8, 13])), min_size=1, max_size=12)

    @settings(max_examples=60, deadline=None)
    @given(runs, st.booleans())
    def check(spans, packer):
        if packer:  # rows end to end with ids 1, 2, ..., then a dead tail
            seg = np.concatenate([np.full(n, i + 1, np.int32) for i, (n, _) in enumerate(spans)]
                                 + [np.zeros(spans[0][1] * 7, np.int32)])
        else:
            seg = np.concatenate([np.full(n, s, np.int32) for n, s in spans])
        seg = seg[None]
        visit = ra.visited_key_tiles(ra.tile_ranges_reference(torch.from_numpy(seg)), key_tile).numpy()
        qi, kj = np.nonzero((seg[0][:, None] == seg[0][None, :]) & (seg[0][None, :] > 0))
        assert visit[0, qi // ra.TILE, kj // key_tile].all()
        assert visit.shape[-1] == -(-seg.shape[1] // key_tile)
        dead = np.array([not (seg[0, i * ra.TILE:(i + 1) * ra.TILE] > 0).any()
                         for i in range(visit.shape[1])])
        assert not visit[0, dead].any()

    check()


# -- model --------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = JaxBertConfig.tiny(vocab_size=300, scan_layers=True)
    jmodel = JaxMemoryModel(jcfg, header_dim=32)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), dummy, dummy))
    pcfg = BertConfig.tiny(vocab_size=300, scan_layers=True)
    pmodel = MemoryModel(pcfg, header_dim=32).eval()
    pmodel.load_state_dict(params_from_flax(params, pcfg))
    return jmodel, params, pmodel


def _pack(seed, budget=128, rows=8):
    rng = np.random.default_rng(seed)
    seqs = [[2] + list(rng.integers(5, 300, size=int(n))) + [3] for n in rng.integers(1, 30, size=5)]
    return seqs, batching.collate_ragged(seqs, budget, rows, pad_id=0)


def _torch_sample(sample):
    return {k: torch.from_numpy(v).long() for k, v in sample.items()}


def test_encode_ragged_matches_jax(models):
    jmodel, params, pmodel = models
    seqs, sample = _pack(0)
    want = np.asarray(jmodel.apply(params, sample, method=jmodel.encode_ragged))
    with torch.no_grad():
        got = pmodel.encode_ragged(_torch_sample(sample)).numpy()
    np.testing.assert_allclose(got[: len(seqs)], want[: len(seqs)], **ENC_TOL)


def test_encode_ragged_matches_padded_encode(models):
    """A request's packed embedding equals its padded-batch embedding (the
    JAX package's 1e-6 gate)."""
    _, _, pmodel = models
    seqs, sample = _pack(1)
    padded = batching._pad_block(seqs, len(seqs), 0, 32)
    with torch.no_grad():
        got = pmodel.encode_ragged(_torch_sample(sample))[: len(seqs)]
        want = pmodel.encode(*(torch.from_numpy(padded[k]).long() for k in ("input_ids", "attention_mask")))
        logits = pmodel.score_ragged(_torch_sample(sample), want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert logits.shape == (8, len(seqs), 2)
