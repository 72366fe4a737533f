"""On-card smoke test of the PyTorch/CUDA port (memvul_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``env``       the card's name, and its name and power limit from nvidia-smi;
2. ``build``     builds every CUDA kernel from ``memvul_tpu_torch/csrc``;
3. ``kernel_anchor_match`` / ``kernel_flash``
                 each kernel against its plain PyTorch version at the main
                 path's shapes, with its time, the plain version's time, the
                 card's bound for the same work and (attention) the time of
                 PyTorch's own ``scaled_dot_product_attention`` as a yardstick
                 the port never calls.  The attention inputs give peaked
                 softmaxes and outputs of order 1, and the phase shows that a
                 lost key tile would fail the check;
4. ``main_path`` the port's corpus-scoring path end to end at the full width of
                 ``configs/config_memory_longctx.json`` (BERT-base, 4096
                 positions, bf16, flash attention): deterministic vocabulary,
                 a synthetic corpus, a 129-anchor bank, random weights from a
                 seed, a ``model.tar.gz``, then ``evaluate_from_archive`` on the
                 card.  The kernels' launch counts are set to 0 just before it
                 and read just after;
5. ``main_path_profile``
                 device time by kernel (torch.profiler) for one batch of the
                 main path's 2048 bucket through the archived model;
6. ``main_path_reference``
                 a small model scored on the card (kernels) and on the CPU
                 (plain versions), which must agree: in f32 through both
                 attention impls, and in bf16 at head dim 64 through the
                 tensor-core flash kernel the main path runs;
7. ``kernels``   one line per ported kernel, then the card's nvidia-smi line,
                 then ``{"ok": true, "device": {...}}`` as the last line.

Every f32 comparison runs with TF32 off for matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so the plain versions compute
in full f32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_memory_longctx.json"

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12  # non-tensor f32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want, atol: float, rtol: float):
    """(max |got − want|, whether every element is within atol + rtol·|want|)."""
    import torch

    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return float("inf"), False
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def rms(x) -> float:
    return float(x.float().pow(2).mean().sqrt())


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- kernel phases -----------------------------------------------------------


def phase_anchor_match(records: dict) -> None:
    import torch

    from memvul_tpu_torch.ops import anchor_match as am

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        (1024, 129, 512, 2, torch.bfloat16, 3e-2),
        (64, 129, 512, 2, torch.bfloat16, 3e-2),
        (1024, 129, 512, 2, torch.float32, 1e-5),
        (64, 129, 512, 2, torch.float32, 1e-5),
        (17, 129, 200, 2, torch.float32, 1e-5),
        (130, 5, 96, 2, torch.float32, 1e-5),
        (5, 7, 64, 3, torch.float32, 1e-5),
    ]
    results = []
    for b, a, d, c, dtype, tol in cases:
        u = torch.randn(b, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(a, d, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(3 * d, c, device="cuda", generator=gen) * 0.1).to(dtype)
        got = am.fused_anchor_match(u, v, w)
        # the plain version on the same values in f32: in bf16 it rounds
        # every intermediate, while the kernel accumulates in f32 and rounds
        # once (the JAX package's bf16 kernel test holds it the same way)
        want = am.anchor_match_reference(u.float(), v.float(), w.float())
        torch.cuda.synchronize()
        err, ok = max_err(got, want, tol, tol)
        row = {"shape": [b, a, d, c], "dtype": str(dtype), "tol": tol,
               "max_abs_err": err, "ok": ok}
        if d == 512 and a == 129:
            item = u.element_size()
            nbytes = (b * d + a * d + 3 * d * c + b * a * c) * item
            flops = 2 * c * b * a * d + 2 * c * (b + a) * d
            row["kernel_ms"] = time_ms(lambda: am.fused_anchor_match(u, v, w), 50)
            row["plain_ms"] = time_ms(lambda: am.anchor_match_reference(u, v, w), 10)
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, F32_FLOPS)
            row["bound_rate"] = "67 TFLOP/s f32 (non-tensor), 3.35 TB/s"
        results.append(row)
        if not ok:
            emit("kernel_anchor_match", ok=False, cases=results)
            raise SystemExit(f"anchor-match kernel disagrees with its plain version: {row}")
    emit("kernel_anchor_match", ok=True, cases=results)
    main = next(r for r in results if r["shape"] == [1024, 129, 512, 2] and "bfloat16" in r["dtype"])
    records["anchor_match"] = {
        "name": "anchor_match",
        "route": "cuda",
        "source": "memvul_tpu_torch/csrc/anchor_match.cu",
        "replaces": "memvul_tpu/ops/pallas/anchor_match.py:128",
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }


def _flash_inputs(b, t, h, d, dtype, gen, lengths=None, pad=0):
    """q/k/v [B, T, H, D] (views of [B, T, H, D + pad] when ``pad``) and the
    padding-mask bias for the given key lengths.

    q and k are 2·N(0, 1), so the scores have a spread of about 4 and each
    row's softmax is peaked on a few keys; v is N(0, 1), so the outputs are
    of order 1 and the atol + rtol·|want| check is tight against them.  A
    missing rescale of the running accumulator or a lost key tile moves an
    output by O(1)."""
    import torch

    from memvul_tpu_torch.ops.attention import mask_to_bias

    q, k, v = (
        (torch.randn(b, t, h, d + pad, device="cuda", generator=gen) * scale).to(dtype)[..., :d]
        for scale in (2.0, 2.0, 1.0)
    )
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    if lengths is not None:
        for i, n in enumerate(lengths):
            mask[i, n:] = 0
    return q, k, v, mask_to_bias(mask, dtype)


def phase_flash(records: dict) -> None:
    import torch
    import torch.nn.functional as F

    from memvul_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths_cpu = torch.Generator().manual_seed(2)

    def lengths(b, t):
        return torch.randint(1, t + 1, (b,), generator=lengths_cpu).tolist()

    # bf16 with head dim 64 on 16-byte-aligned tensors takes the tensor-core
    # kernel; f32, other head dims and unaligned views (pad 4) the CUDA-core one
    cases = [
        # (B, T, H, D, dtype, tol, key lengths, view padding)
        (1024, 256, 12, 64, torch.bfloat16, 3e-2, lengths(1024, 256), 0),
        (64, 4096, 12, 64, torch.bfloat16, 3e-2, lengths(64, 4096), 0),
        (3, 300, 12, 64, torch.bfloat16, 3e-2, [300, 173, 0], 0),  # row 2 fully masked
        (3, 300, 12, 64, torch.bfloat16, 3e-2, [300, 173, 0], 4),
        (2, 37, 4, 32, torch.bfloat16, 3e-2, [37, 5], 0),
        (3, 300, 12, 64, torch.float32, 2e-5, [300, 173, 0], 0),
        (2, 37, 4, 16, torch.float32, 2e-5, [37, 5], 0),
    ]
    results = []
    for b, t, h, d, dtype, tol, lens, pad in cases:
        q, k, v, bias = _flash_inputs(b, t, h, d, dtype, gen, lens, pad)
        got = fa.flash_attention(q, k, v, bias)
        want = fa.flash_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, tol, tol)
        row = {"shape": [b, t, h, d], "dtype": str(dtype), "view_pad": pad, "tol": tol,
               "max_abs_err": err, "ok": ok, "want_rms": rms(want), "err_over_rms": err / rms(want)}
        if t in (256, 4096):
            # power of the check: the plain version with the first 64 keys of
            # every row masked must fail it (a kernel that lost a key tile)
            lost = bias.clone()
            lost[..., :64] = torch.finfo(bias.dtype).min
            row["lost_tile_err"], lost_ok = max_err(
                fa.flash_attention_reference(q, k, v, lost), want, tol, tol)
            if lost_ok:
                emit("kernel_flash", ok=False, cases=results + [row])
                raise SystemExit(f"the flash check cannot see a lost key tile: {row}")
            item = q.element_size()
            nbytes = 4 * b * t * h * d * item + b * t * 4
            flops = 4 * b * h * t * t * d
            row["kernel_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, bias), 5)
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias), 2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5
            )
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, BF16_TENSOR_FLOPS)
            row["bound_rate"] = "989 TFLOP/s bf16 tensor cores, 3.35 TB/s"
            row["kernel_tflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e12
            # the CUDA-core kernel on the same values, through an unaligned view
            qs, ks, vs = (F.pad(x, (0, 4))[..., :d] for x in (q, k, v))
            row["cuda_core_kernel_ms"] = time_ms(lambda: fa.flash_attention(qs, ks, vs, bias), 2)
        results.append(row)
        if not ok:
            emit("kernel_flash", ok=False, cases=results)
            raise SystemExit(f"flash kernel disagrees with its plain version: {row}")
    emit("kernel_flash", ok=True, cases=results)
    main = next(r for r in results if r["shape"] == [64, 4096, 12, 64])
    records["flash_attention"] = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "memvul_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "memvul_tpu/ops/pallas/flash_kernel.py:244",
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }


# -- main path ---------------------------------------------------------------


def _random_flax_params(model_cfg: dict, vocab_size: int, seed: int) -> dict:
    """Full-width MemoryModel params in the JAX package's (flax) layout,
    drawn from a seed with numpy: N(0, 0.02) weights, zero biases, unit
    LayerNorm scales."""
    import numpy as np

    from memvul_tpu_torch.build import encoder_config

    enc = encoder_config(model_cfg.get("encoder"), vocab_size)
    rng = np.random.default_rng(seed)
    hid, heads, inter, layers = enc.hidden_size, enc.num_heads, enc.intermediate_size, enc.num_layers
    dh = hid // heads
    header_dim = int(model_cfg.get("header_dim", 512))

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def ln(*lead):
        return {"scale": ones(*lead, hid), "bias": zeros(*lead, hid)}

    stack = (layers,) if enc.scan_layers else ()

    def layer(lead):
        return {
            "attention": {
                **{n: {"kernel": normal(*lead, hid, heads, dh), "bias": zeros(*lead, heads, dh)}
                   for n in ("query", "key", "value")},
                "output": {"kernel": normal(*lead, heads, dh, hid), "bias": zeros(*lead, hid)},
                "output_LayerNorm": ln(*lead),
            },
            "intermediate": {"kernel": normal(*lead, hid, inter), "bias": zeros(*lead, inter)},
            "output": {"kernel": normal(*lead, inter, hid), "bias": zeros(*lead, hid)},
            "output_LayerNorm": ln(*lead),
        }

    if enc.scan_layers:
        encoder = {"layers": {"layer": layer(stack)}}
    else:
        encoder = {f"layer_{i}": layer(()) for i in range(layers)}
    return {
        "params": {
            "bert": {
                "embeddings": {
                    "word_embeddings": {"embedding": normal(enc.vocab_size, hid)},
                    "position_embeddings": {"embedding": normal(enc.max_position_embeddings, hid)},
                    "token_type_embeddings": {"embedding": normal(enc.type_vocab_size, hid)},
                    "LayerNorm": ln(),
                },
                "encoder": encoder,
            },
            "pooler": {"dense": {"kernel": normal(hid, hid), "bias": zeros(hid)}},
            "header": {"dense": {"kernel": normal(hid, header_dim), "bias": zeros(header_dim)}},
            "pair_kernel": normal(3 * header_dim, 2),
        }
    }


def _synthetic_anchors(n: int, seed: int) -> dict:
    """``n`` CWE anchors with CWE-description-like texts (a few dozen to a
    few hundred words)."""
    import random

    from memvul_tpu_torch.data.synthetic import _VULN_PHRASES

    rng = random.Random(seed)
    anchors = {}
    for i in range(n):
        words = max(12, min(int(rng.lognormvariate(4.3, 0.6)), 600))
        parts, count = [f"weakness class {i} where the product"], 5
        while count < words:
            p = rng.choice(_VULN_PHRASES)
            parts.append(p)
            count += len(p.split())
        anchors[f"CWE-{1000 + i}"] = " ".join(parts)
    return anchors


def phase_main_path(workdir: Path, records: dict, reports_wanted: int = 512) -> None:
    import numpy as np
    import torch

    from memvul_tpu_torch.archive import save_archive
    from memvul_tpu_torch.build import evaluate_from_archive
    from memvul_tpu_torch.config import load_config
    from memvul_tpu_torch.data.synthetic import corpus_texts, generate_corpus
    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = load_config(CONFIG)
    per_project = 32
    reports, cve = generate_corpus(
        num_projects=max(1, reports_wanted // per_project),
        reports_per_project=per_project, seed=0, realistic_lengths=True,
    )
    anchors = _synthetic_anchors(129, seed=1)
    test_path = workdir / "test_project.json"
    test_path.write_text(json.dumps(reports))
    cve_path = workdir / "CVE_dict.json"
    cve_path.write_text(json.dumps(cve))
    anchor_path = workdir / "CWE_anchor_golden_project.json"
    anchor_path.write_text(json.dumps(anchors))
    tok = WordPieceTokenizer.build_deterministic(
        corpus_texts(reports) + list(anchors.values()), vocab_size=30522
    )
    vocab_path = workdir / "vocab.txt"
    tok.save_vocab_txt(vocab_path)
    # the synthetic corpus has a few hundred distinct words; the embedding
    # table keeps bert-base's 30522 rows all the same
    model_cfg = dict(cfg["model"], encoder=dict(cfg["model"]["encoder"], vocab_size=30522))
    archived = dict(cfg, model=model_cfg)
    archived["dataset_reader"] = dict(cfg["dataset_reader"], cve_path=str(cve_path),
                                      anchor_path=str(anchor_path))
    params = _random_flax_params(model_cfg, tok.vocab_size, seed=0)
    archive = save_archive(workdir / "model.tar.gz", archived, params, tokenizer_file=vocab_path)
    del params
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    am.launches = 0
    t1 = time.perf_counter()
    metrics = evaluate_from_archive(
        archive, test_path, workdir / "eval",
        overrides={"evaluation": cfg["evaluation"]}, device="cuda",
    )
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    flash_launches, match_launches = fa.launches, am.launches
    peak_bytes = torch.cuda.max_memory_allocated()

    # what came out: one record per report, 129 finite probabilities in [0, 1]
    result = workdir / "eval" / "model_memory_result.json"
    recs = [r for line in result.read_text().splitlines() if line.strip() for r in json.loads(line)]
    if len(recs) != len(reports):
        raise SystemExit(f"main path wrote {len(recs)} records for {len(reports)} reports")
    probs = np.array([[r["predict"][a] for a in anchors] for r in recs], np.float64)
    if probs.shape != (len(reports), 129) or not np.isfinite(probs).all() \
            or probs.min() < 0.0 or probs.max() > 1.0:
        raise SystemExit(f"main path probabilities out of range: shape {probs.shape}")
    saved = json.loads((workdir / "eval" / "model_memory_metric_all.json").read_text())
    keys = ["TP", "FN", "TN", "FP", "pd&recall", "prec", "f1", "ap", "auc", "thres"]
    missing = [k for k in keys if k not in saved]
    if missing or saved["TP"] + saved["FN"] + saved["TN"] + saved["FP"] != len(reports):
        raise SystemExit(f"metric file is wrong: missing {missing}, {saved}")
    batches, chunks = int(metrics["s_batches"]), int(metrics["s_anchor_chunks"])
    layers = 12
    if flash_launches != layers * (batches + chunks) or match_launches != batches:
        raise SystemExit(
            f"launch counts off: flash {flash_launches} (want {layers * (batches + chunks)}), "
            f"anchor_match {match_launches} (want {batches})"
        )
    records["anchor_match"]["launches"] = match_launches
    records["flash_attention"]["launches"] = flash_launches
    emit(
        "main_path", ok=True, config=str(CONFIG.relative_to(ROOT)),
        reports=len(reports), anchors=129, vocab_size=tok.vocab_size,
        setup_s=setup_s, wall_s=wall_s,
        reports_per_s=len(reports) / metrics["s_elapsed_s"],
        scoring_s=metrics["s_elapsed_s"], anchor_encode_s=metrics["s_anchor_encode_s"],
        bucket_seconds=metrics["s_bucket_seconds"], bucket_batches=metrics["s_bucket_batches"],
        bucket_live_rows=metrics["s_bucket_rows"], bucket_row_slots=metrics["s_bucket_row_slots"],
        host_seconds={k: metrics[f"s_{k}"] for k in ("feed_wait_s", "launch_s", "sync_s")},
        batches=batches, anchor_chunks=chunks,
        flash_launches=flash_launches, anchor_match_launches=match_launches,
        peak_memory_gib=peak_bytes / 2**30, f1=saved["f1"], auc=saved["auc"],
        card=nvidia_smi_line(),
    )


def phase_profile(archive: Path, rows: int = 128, length: int = 2048) -> None:
    """Device time by kernel for one scoring batch of the main path's
    2048 bucket (128 rows), through the archived full-width model, by
    torch.profiler (CUDA events give the batch's total device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.models.memory import anchor_probs

    arch = load_archive(archive, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(5, 300, (rows, length), device="cuda", generator=gen)
    mask = torch.ones_like(ids)
    bank = torch.randn(129, 512, device="cuda", generator=gen).to(torch.bfloat16)

    def batch():
        with torch.no_grad():
            return anchor_probs(arch.model(ids, mask, anchors=bank))

    batch_ms = time_ms(batch, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        batch()
        torch.cuda.synchronize()
    by_name: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if not us or evt.key.startswith(("aten::", "cuda", "Memcpy", "Memset", "ProfilerStep")):
            continue
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    groups: dict = {}
    for name, ms in by_name.items():
        low = name.lower()
        group = ("flash_fwd" if "flash_fwd" in low else
                 "anchor_match" if "anchor_match" in low else
                 "gemm" if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "sm90")) else
                 "layer_norm" if "layer_norm" in low else
                 "gelu" if "gelu" in low else "other")
        groups[group] = groups.get(group, 0.0) + ms
    total = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("main_path_profile", shape=[rows, length], batch_ms=batch_ms,
         kernel_ms=groups, kernel_share={k: v / total for k, v in groups.items()} if total else {},
         device_busy_share=total / batch_ms if batch_ms else None,
         top_kernels=[[name[:80], ms] for name, ms in top])
    del arch


# bf16 card-vs-CPU limits of the small model: the largest |Δ| over the live
# tokens' final hidden states, relative to their RMS, and the largest |Δ|
# of a per-anchor probability.  The phase also shows that the hidden-state
# limit would catch a lost key tile.
BF16_HIDDEN_REL = 0.25
BF16_PROBS_ABS = 1e-3


def phase_main_path_reference() -> None:
    """A small memory model scored on the card (kernels) and on the CPU
    (plain versions), which must agree: in f32 through both attention impls
    (per-anchor probabilities to rtol 1e-4 / atol 1e-5), and in bf16 at head
    dim 64 through flash, the main path's tensor-core kernel, with the
    attention weights scaled up so each softmax is peaked and the attention
    branch weighs in the residual stream (the final hidden states and the
    probabilities, to the limits above)."""
    import numpy as np
    import torch

    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel, anchor_probs

    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(5, 500, size=(9, 300)))
    mask = torch.ones_like(ids)
    for i, n in enumerate(rng.integers(1, 301, size=9)):
        mask[i, n:] = 0
    bank_ids = torch.as_tensor(rng.integers(5, 500, size=(7, 300)))
    bank_mask = torch.ones_like(bank_ids)
    live = mask.bool()

    results = {}
    for impl, dtype in (("flash", torch.float32), ("xla", torch.float32),
                        ("flash", torch.bfloat16)):
        cfg = BertConfig(
            vocab_size=500, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=320, attention_impl=impl,
            dtype=dtype,
        )
        torch.manual_seed(0)
        model = MemoryModel(cfg, header_dim=64).eval()
        if dtype == torch.bfloat16:
            with torch.no_grad():
                for layer in model.bert.encoder.layer:
                    # scores of spread about 4 instead of about 0.05, and an
                    # attention branch that weighs in the residual stream
                    attention = layer.attention
                    attention.self.query.weight.mul_(9.0)
                    attention.self.key.weight.mul_(9.0)
                    attention.self.value.weight.mul_(4.0)
                    attention.output.dense.weight.mul_(4.0)
        out, hidden = {}, {}
        for device in ("cpu", "cuda"):
            m = model.to(device)
            with torch.no_grad():
                bank = m.encode(bank_ids.to(device), bank_mask.to(device))
                u = m.encode(ids.to(device), mask.to(device))
                out[device] = anchor_probs(m.match_anchors(u, bank)).cpu()
                hidden[device] = m.bert(ids.to(device), mask.to(device)).cpu().float()[live]
        name = f"{impl}_{str(dtype).split('.')[-1]}"
        if dtype == torch.float32:
            err, ok = max_err(out["cuda"], out["cpu"], 1e-5, 1e-4)
            results[name] = {"max_abs_err": err, "ok": ok}
        else:
            err, _ = max_err(out["cuda"], out["cpu"], 0.0, 0.0)
            h_err, _ = max_err(hidden["cuda"], hidden["cpu"], 0.0, 0.0)
            h_rel = h_err / rms(hidden["cpu"])
            # power of the check: the CPU model with the first 64 keys of
            # every row masked off (a kernel that lost a key tile)
            lost_mask = mask.clone()
            lost_mask[:, :64] = 0
            with torch.no_grad():
                lost = model.to("cpu").bert(ids, lost_mask).float()[live]
            lost_rel = max_err(lost, hidden["cpu"], 0.0, 0.0)[0] / rms(hidden["cpu"])
            ok = err <= BF16_PROBS_ABS and BF16_HIDDEN_REL < lost_rel and h_rel <= BF16_HIDDEN_REL
            results[name] = {"max_abs_err": err, "hidden_max_abs_err": h_err,
                             "hidden_err_over_rms": h_rel, "lost_tile_hidden_err_over_rms": lost_rel,
                             "ok": ok}
        if not ok:
            emit("main_path_reference", ok=False, results=results)
            raise SystemExit(f"card and CPU disagree on the small model ({name}): {results[name]}")
    emit("main_path_reference", ok=True,
         tol={"f32": {"rtol": 1e-4, "atol": 1e-5},
              "bf16": {"hidden_err_over_rms": BF16_HIDDEN_REL, "probs_abs": BF16_PROBS_ABS}},
         results=results)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on the card only",
              file=sys.stderr)
        return 1
    # the port must be beside this script: fail before printing anything
    from memvul_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    emit("env", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    lib_path = _kernels.build(force=True)
    _kernels.library()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib_path.relative_to(ROOT)),
         ptxas=[l.strip() for l in _kernels.build_log.splitlines()
                if "registers" in l or "spill" in l or "Compiling entry" in l])

    records: dict = {}
    phase_anchor_match(records)
    phase_flash(records)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        phase_main_path(Path(tmp), records)
        phase_profile(Path(tmp) / "model.tar.gz")
    phase_main_path_reference()

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    kernels = [{k: rec[k] for k in order} for rec in records.values()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
