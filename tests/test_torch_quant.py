"""The port's int8 tier against the JAX package's on the CPU: the
quantizer and both int8 matmuls bitwise against the JAX functions run
eagerly (within 2 f32 ulp of their ``jax.jit`` forms), the port's dynamic
and prequantized paths bitwise against each other, the zero-row and
absmax-tie edges, a tiny encoder and memory model in both quant modes
against JAX's on the same params, and the serving cascade's routing and
answers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from memvul_tpu import archive as jax_archive
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.ops import quant as jq
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.build import serve_from_archive
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.models.bert import BertConfig
from memvul_tpu_torch.models.convert import params_from_flax
from memvul_tpu_torch.models.memory import MemoryModel, anchor_probs
from memvul_tpu_torch.ops import quant
from memvul_tpu_torch.serving import InprocessClient, ScoringService, ServiceConfig

# f32 spacing at the largest |output|: jax.jit fuses the dequantize
# ``acc * xs * ws`` into one expression whose rounding can differ from the
# eager two-step product by an ulp (the reference's own seed failure,
# test_prequant_matches_dynamic_bitwise_property, is that one ulp); two
# leave room for the bf16 → f32 input case
JIT_ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


SHAPES = [(1, 3, 4), (6, 40, 24), (17, 64, 48), (33, 128, 96), (5, 768, 16)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_matmuls_bitwise_equal_to_jax_eager(m, k, n, scale):
    x, w = _x(m * k, (m, k), scale), _x(k * n + 1, (k, n), 1.0 / scale)
    q, s = quant.quantize_rowwise(torch.from_numpy(x))
    jq_, js = jq.quantize_rowwise(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    wq, ws = quant.quantize_colwise(torch.from_numpy(w))
    jwq, jws = jq.quantize_colwise(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    pre = quant.int8_matmul_prequant(torch.from_numpy(x), wq, ws).numpy()
    np.testing.assert_array_equal(
        pre, np.asarray(jq.int8_matmul_prequant(jnp.asarray(x), jwq, jws)))
    # the port's dynamic and prequantized paths give the same bits
    np.testing.assert_array_equal(pre, got)
    # against jax.jit, within JIT_ULPS f32 ulp of the largest output
    for fn, args in ((jq.int8_matmul, (x, w)), (jq.int8_matmul_prequant, (x, jwq, jws))):
        jitted = np.asarray(jax.jit(fn)(*args))
        ulp = np.spacing(np.float32(np.abs(jitted).max()))
        assert np.abs(jitted - got).max() <= JIT_ULPS * ulp


@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                                (torch.float32, torch.bfloat16),
                                                (torch.bfloat16, torch.bfloat16)])
def test_dtypes_match_jax_eager(in_dtype, out_dtype):
    to_j = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    x32, w = _x(10, (12, 64)), _x(11, (64, 40))
    x = torch.from_numpy(x32).to(in_dtype)
    got = quant.int8_matmul(x, torch.from_numpy(w), out_dtype=out_dtype)
    want = jq.int8_matmul(jnp.asarray(x32).astype(to_j[in_dtype]), jnp.asarray(w),
                          out_dtype=to_j[out_dtype])
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_zero_row_and_absmax_tie_edges():
    x = torch.tensor([[0.0] * 8, [1.5, -1.5, 0.75, 0.0, 0.0, 0.0, 0.0, 0.0]])
    q, s = quant.quantize_rowwise(x)
    jq_, js = jq.quantize_rowwise(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.isfinite(s).all() and (s > 0).all()
    assert (q[0] == 0).all() and q[1, 0] == 127 and q[1, 1] == -127
    w = torch.from_numpy(_x(9, (32, 16)))
    out = quant.int8_matmul(torch.zeros(3, 32), w)
    assert torch.isfinite(out).all() and (out == 0).all()
    # half-way quotients round to even, as jnp.round does
    halves = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5]])
    np.testing.assert_array_equal(quant.quantize_rowwise(halves)[0].numpy(),
                                  np.asarray(jq.quantize_rowwise(jnp.asarray(halves.numpy()))[0]))


def test_quant_linear_modes_bitwise_and_keep_the_state_dict():
    torch.manual_seed(0)
    dyn = quant.QuantLinear(64, 24, "int8_dynamic")
    pre = quant.QuantLinear(64, 24, "int8")
    pre.load_state_dict(dyn.state_dict())
    assert set(pre.state_dict()) == set(torch.nn.Linear(64, 24).state_dict())
    x = torch.randn(5, 7, 64)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = dyn.quantized(x, dtype), pre.quantized(x, dtype)
        assert a.dtype == dtype and a.shape == (5, 7, 24)
        assert torch.equal(a, b)
    assert pre.weight_q.dtype == torch.int8 and "weight_q" not in pre.state_dict()
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.QuantLinear(4, 4, "int4")


# -- the model in both quant modes against JAX's ---------------------------------


def _batch(seed, b=5, t=24, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    for i, n in enumerate(rng.integers(1, t + 1, size=b)):
        mask[i, n:] = 0
    return ids, mask


# int8 codes are a step function of the activations: where the two
# frameworks' f32 rounding of an activation (about 1e-7) straddles a
# rounding boundary a code moves by one, an output by about a scale step
MODEL_INT8_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mode", ["int8_dynamic", "int8"])
def test_memory_model_int8_matches_jax(mode):
    # the JAX package's int8 cache ("quant" collection) is not scanned:
    # its int8 twin needs the unscanned layer layout
    jcfg = JaxBertConfig.tiny(vocab_size=300)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(jcfg, header_dim=32).init(jax.random.PRNGKey(3), dummy, dummy))
    jmodel = JaxMemoryModel(jcfg.replace(quant=mode), header_dim=32)
    variables = params
    if mode == "int8":
        _, qvars = jmodel.apply(params, dummy, mutable=["quant"])
        variables = {**params, "quant": qvars["quant"]}
    pcfg = BertConfig.tiny(vocab_size=300, quant=mode)
    pmodel = MemoryModel(pcfg, header_dim=32).eval()
    pmodel.load_state_dict(params_from_flax(params, pcfg))
    ids, mask = _batch(1)
    bank_ids, bank_mask = _batch(2, b=7)
    sample = {"input_ids": ids, "attention_mask": mask}
    bank_want = np.asarray(jmodel.apply(variables, {"input_ids": bank_ids, "attention_mask": bank_mask}))
    probs_want = anchor_probs(torch.tensor(np.asarray(
        jmodel.apply(variables, sample, anchors=bank_want)))).numpy()
    with torch.no_grad():
        bank = pmodel.encode(torch.from_numpy(bank_ids).long(), torch.from_numpy(bank_mask).long())
        probs = anchor_probs(pmodel({k: torch.from_numpy(v).long() for k, v in sample.items()},
                                    anchors=bank)).numpy()
        hidden = pmodel.bert(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    from memvul_tpu.models import BertEncoder as JaxBertEncoder

    enc_vars = {"params": params["params"]["bert"]}
    if mode == "int8":
        enc_vars["quant"] = variables["quant"]["bert"]
    hidden_want = np.asarray(JaxBertEncoder(jmodel.config).apply(enc_vars, ids, mask))
    np.testing.assert_allclose(hidden, hidden_want, **MODEL_INT8_TOL)
    np.testing.assert_allclose(bank.numpy(), bank_want, **MODEL_INT8_TOL)
    np.testing.assert_allclose(probs, probs_want, **MODEL_INT8_TOL)
    # the six projections per layer are int8, the pooler and header not
    kinds = {name: type(m).__name__ for name, m in pmodel.named_modules()
             if isinstance(m, torch.nn.Linear)}
    assert sum(k == "QuantLinear" for k in kinds.values()) == 6 * pcfg.num_layers
    assert kinds["pooler.dense"] == kinds["header.dense"] == "Linear"


# -- the cascade --------------------------------------------------------------------


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cascade")
    ws = build_workspace(tmp / "ws", seed=11)
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(0), dummy, dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": ws["paths"]["cve"],
                           "anchor_path": ws["paths"]["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab}},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    arch = load_archive(archive, device="cpu")
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors())
    texts = [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]
    jarch = jax_archive.load_archive(archive)

    def make(low, high):
        p = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                             buckets=[48], encoder_precision="int8", score_impl="cascade",
                             cascade_low=low, cascade_high=high)
        p.encode_anchors(anchors)
        return p

    def make_jax(low, high):
        p = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, batch_size=8, max_length=48,
                         buckets=[48], encoder_precision="int8", score_impl="cascade",
                         cascade_low=low, cascade_high=high, aot_warmup=False)
        p.encode_anchors(anchors)
        return p

    return {"make": make, "make_jax": make_jax, "texts": texts, "archive": archive}


# the routing is a comparison of the int8 tier's best probability with the
# band: a row within 1e-5 of an edge may fall either side between the two
# frameworks (they agree to about 1e-6 here), so such rows are exempt
BAND_EDGE = 1e-5


def test_cascade_routes_the_rows_jax_routes(cascade):
    texts = cascade["texts"]
    mine, theirs = cascade["make"](0.0, 1.0), cascade["make_jax"](0.0, 1.0)
    best = mine.score_texts(texts, impl="int8").max(axis=1)
    best_jax = np.asarray(theirs.score_texts(texts, impl="int8")).max(axis=1)
    np.testing.assert_allclose(best, best_jax, **MODEL_INT8_TOL)
    cut = float((best.min() + best.max()) / 2.0)
    checked = {True: 0, False: 0}
    for b, bj in zip(best, best_jax):
        if abs(bj - cut) < BAND_EDGE:
            continue
        assert (b <= cut) == (bj <= cut)
        checked[bool(bj <= cut)] += 1
    assert checked[True] and checked[False] and sum(checked.values()) >= len(texts) // 2
    # the offline cascade: in-band rows carry the fp32 bits, the rest int8's
    p = cascade["make"](0.0, cut)
    out = p.score_texts(texts, impl="cascade")
    fp32 = p.score_texts(texts, impl="bucketed")
    int8 = p.score_texts(texts, impl="int8")
    for i, b in enumerate(best):
        np.testing.assert_array_equal(out[i], fp32[i] if b <= cut else int8[i])


def test_cascade_service_rescored_equal_bucketed(cascade):
    texts = cascade["texts"]
    probe = cascade["make"](0.0, 1.0)
    best = probe.score_texts(texts, impl="int8").max(axis=1)
    cut = float((best.min() + best.max()) / 2.0)
    predictor = cascade["make"](0.0, cut)
    assert predictor.warmup_compile() == 2  # one shape, two tiers
    service = ScoringService(predictor, config=ServiceConfig(
        max_batch=8, max_wait_ms=1.0, max_queue=100, default_deadline_ms=30000.0))
    client = InprocessClient(service)
    labels = predictor.anchor_labels
    n_in = n_out = 0
    try:
        for text, b in zip(texts, best):
            response = client.score(text)
            assert response["status"] == "ok"
            served = np.array([response["predict"][a] for a in labels], np.float32)
            if b <= cut:
                expected = predictor.score_texts([text], impl="bucketed")[0]
                n_in += 1
            else:
                expected = predictor.score_texts([text], impl="int8")[0]
                n_out += 1
            np.testing.assert_array_equal(served, expected)
    finally:
        service.drain()
    assert n_in and n_out
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.cascade_rescored"] == n_in
    assert counters["serve.cascade_shortcircuit"] == n_out


def test_serve_from_archive_cascade_and_band_checks(cascade):
    service = serve_from_archive(
        cascade["archive"], device="cpu",
        overrides={"serving": {"score_impl": "cascade", "max_length": 48, "buckets": [16, 48],
                               "max_batch": 8, "cascade_low": 0.0, "cascade_high": 1.0}})
    try:
        assert service.predictor.encoder_precision == "int8"
        r = InprocessClient(service).score(cascade["texts"][0])
        assert r["status"] == "ok"
    finally:
        service.drain()
    assert service.registry.snapshot()["counters"]["serve.cascade_rescored"] == 1
    with pytest.raises(ValueError, match="cascade band"):
        serve_from_archive(cascade["archive"], device="cpu",
                           overrides={"serving": {"score_impl": "cascade", "cascade_low": 0.9,
                                                  "cascade_high": 0.1}})
