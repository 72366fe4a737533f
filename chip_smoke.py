"""On-card smoke test of the PyTorch/CUDA port (memvul_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``env``       the card's name, and its name and power limit from nvidia-smi;
2. ``build``     builds every CUDA kernel from ``memvul_tpu_torch/csrc``;
3. ``kernel_anchor_match`` / ``kernel_flash`` / ``kernel_ragged``
                 each kernel against its plain PyTorch version at the main
                 paths' shapes, with its time, the plain version's time, the
                 card's bound for the same work and (attention) the time of
                 PyTorch's own ``scaled_dot_product_attention`` as a yardstick
                 the port never calls.  The attention inputs give peaked
                 softmaxes and outputs of order 1, and the phases show that a
                 lost key tile (and, ragged, a leak across requests) would
                 fail the check.  ``kernel_anchor_match`` times K1 at every
                 row count the paths launch it with (16: a serve pack; 128 to
                 1024: the main path's buckets) and requires the same bits
                 from two runs.  ``kernel_flash`` times K2 at every shape
                 the main path launches it with (derived from the
                 configuration) and checks that the bf16 launch ran the wgmma
                 kernel; ``kernel_ragged`` checks K3's wgmma kernel ran on
                 the serve pack, adds a stress pack (a 512-token request
                 among short ones, boundaries inside tiles, a dead tail),
                 poisons each output's memory with NaN before the call (an
                 unwritten element fails) and holds the device's tile-range
                 table against its plain version.  Both
                 attention phases print their wgmma kernel's registers and
                 spills as ptxas reported them (a spill or a serialized
                 wgmma fails).  ``kernel_flash`` also times K2 at the train
                 step's shapes, and ``kernel_flash_grad`` holds K2 under
                 autograd (output and dq/dk/dv) against the plain version in
                 f32 at those shapes;
4. ``main_path`` the port's corpus-scoring path end to end at the full width of
                 ``configs/config_memory_longctx.json`` (BERT-base, 4096
                 positions, bf16, flash attention): deterministic vocabulary,
                 a synthetic corpus, a 129-anchor bank, random weights from a
                 seed, a ``model.tar.gz``, then ``evaluate_from_archive`` on the
                 card.  The kernels' launch counts are set to 0 just before it
                 and read just after; ``kernel_flash_shapes`` then puts K2's
                 time at each shape beside its launches in this run;
5. ``serve_path`` the packed serving path on the same archive:
                 ``serve_from_archive`` with ``score_impl`` "ragged" and then
                 "continuous", 256 requests from 16 client threads and 8 over
                 HTTP, the launch counts set to 0 after each service is built
                 and read after its traffic, and the responses held against
                 the bucketed path on the card; ``kernel_anchor_match_shapes``
                 then puts K1's time at each row count beside its launches
                 in both paths' runs;
   ``main_path_auto`` / ``main_path_int8`` ``evaluate_from_archive`` of the
                 same archive and corpus with the reference's own override
                 files verbatim (``configs/test_config_memory.json``: auto-8
                 buckets, warmup; ``configs/test_config_memory_int8.json``:
                 the encoder in dynamic int8), K2 and K1 held against their
                 plain versions at the auto shapes (some with T % 64 != 0,
                 where a read past Tk into the next sequence would fail the
                 check), and the int8 run's drift against the bf16 run;
   ``int8_linear`` the int8 linear (quantize, ``torch._int_mm``, dequantize)
                 against bf16 ``F.linear`` at the encoder's projections, and
                 the cached-weight mode's bits against the dynamic one's;
   ``evaluate_resume`` a small dirty corpus scored with resume, quarantine
                 and anchor attribution, killed after a few batches and
                 resumed: the bytes of an uninterrupted run;
   ``serve_cascade`` ``score_impl`` "cascade" served from the same archive;
                 rescored answers hold the bucketed strategy's bits;
   ``serve_identity`` the small f32 model's archive served "continuous" with
                 ``prefix_share`` on (duplicates aliased inside packs), each
                 response held against its own request's answer on the CPU,
                 tightly enough that an answer handed to another request
                 would fail;
   ``train_path`` ``train_from_config`` at the full width of the same
                 configuration on a ``build_workspace`` corpus: a few optimizer
                 steps, validation (K1 and K2 counted around it), the
                 archive, ``evaluate_from_archive`` of it; then a 2-step run
                 with attention dropout 0 whose train steps must launch K2
                 12 layers × 2 towers × microbatches times; and the host
                 wall against the device time of single train steps
                 (``train_step_profile``);
   ``pretrain_path`` MLM further pretraining with ``configs/further_pretrain.json``
                 at its widths (the encoder stacked, bert-base's table): a
                 few updates, the held-out loss and perplexity, the encoder
                 carried bit for bit into a memory model's training and
                 refused by an unstacked one; a dropout-0 run whose updates
                 must launch K2 12 layers × grad_accum times;
   ``single_path`` MemVul-m: ``configs/config_single.json`` trained at full
                 width with flash attention, validated, archived, then 512
                 reports scored with ``configs/test_config_single.json``
                 verbatim (K2 counted and held against its plain version at
                 every auto shape) and again through the "xla" attention,
                 which must agree;
   ``cnn_path``  TextCNN: ``configs/config_cnn.json`` on a corpus-built word
                 vocabulary, trained, archived, 512 reports scored with
                 ``configs/test_config_cnn.json`` verbatim;
   ``score_corpus_path`` ``score_corpus`` of the main path's archive and
                 corpus with ``configs/test_config_memory.json``'s section on
                 two worker processes sharing the card, one SIGKILLed at its
                 third row and a transient ``score.batch`` fault retried:
                 merged records byte-identical to a single-process
                 ``evaluate_from_archive`` by report, the same metric file,
                 each worker's K1 and K2 launches (from its telemetry) what
                 its warmup, batches and anchor chunks need;
   ``bank_path`` the ``bank`` CLI (build 129 anchors; diff: retire 8,
                 reweight 4; shadow replay of the merged results; promote),
                 then a live ragged service serving 256 requests without and
                 with a ``ShadowScorer`` of the 121-anchor candidate (answers
                 bitwise the same, every request shadow-scored through K3),
                 ``promote`` (answers those of the candidate, winners its
                 weighted argmax) and ``demote``,
                 and ``evaluate_cascade`` on 128 reports; K1 held at A = 121
                 and K2 at the replay's shape;
   ``selfcheck`` ``python -m memvul_tpu_torch selfcheck`` on the card;
   ``fleet_path`` the serving plane's fleet on the same archive:
                 ``serve_from_archive`` with 2 "ragged" replicas on the card
                 (a CUDA stream each) behind the router, tracing on; 256
                 closed-loop requests from 16 clients through ``loadgen``
                 (requests/s beside one replica's and beside a fleet whose
                 replicas share the default stream, in turns); the same
                 with ``replica.kill`` armed on replica-1 (one kill, one
                 restart, no hang, the fleet invariant); ``rolling_swap`` to
                 ``bank_path``'s candidate under load with replica-1 killed
                 mid-rollout (one bank version per response, the killed
                 replica back on version 2); a second fleet with a named
                 tenant and the admission cache under ``dedup`` traffic
                 (each tenant's own bank, hits bitwise their misses and no
                 pack); ``/healthz``, ``/metrics``, ``/tracez`` and a
                 tenant-header ``POST /score`` over HTTP;
   ``ops_plane_path`` the serving ops plane on the same archive: two
                 ``python -m memvul_tpu_torch serve`` processes on the card
                 behind a ``HostBalancer`` under 256 closed-loop requests,
                 host-1's process group SIGKILLed mid-load (rerouted,
                 restarted, none lost, answers held against the bucketed
                 path, each process's launches read from its
                 ``/programz``), ``serve --hosts`` over them; a router
                 autoscaled from one replica by a burst at 1.5x the
                 single-service rate and back to one when idle; the flight
                 recorder at a 0.5 s cadence, whose dead-lettered batches
                 fire ``serve_error_rate`` and write one incident bundle,
                 with ``/metricsz``, ``/alertz``, ``/programz``, the
                 device-memory gauge and ``program.mfu`` in (0, 1]; and a
                 ``POST /profilez`` capture under load whose trace names
                 the K3 and K1 kernels;
6. ``main_path_profile`` / ``serve_pack_profile``
                 device time by kernel (torch.profiler) for one batch of the
                 main path's 2048 bucket and for one serve pack's round trip
                 through the archived model;
7. ``main_path_reference`` / ``ragged_reference`` / ``train_reference``
                 a small model scored on the card (kernels) and on the CPU
                 (plain versions), padded and then packed, which must agree:
                 in f32 (with ScalarMix too), and in bf16 at head dim 64
                 through the tensor-core attention kernels the main paths
                 run; and the same model
                 trained a few steps on both from the same weights and
                 stacks; ``pretrain_reference`` a small f32 MLM trained on
                 both from the same weights and masks;
8. ``kernels``   one line per ported kernel, then the card's nvidia-smi line,
                 then ``{"ok": true, "device": {...}}`` as the last line.

Every f32 comparison runs with TF32 off for matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so the plain versions compute
in full f32.
"""

from __future__ import annotations

import collections
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_memory_longctx.json"

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12  # non-tensor f32: an FFMA is two operations
F32_INSTRUCTIONS_PER_S = F32_FLOPS / 2  # FP32 instructions: 132 SMs × 128 lanes × the clock


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


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: its kernels' own time, summed by
    torch.profiler over ``iters`` calls, without the gaps between them."""
    groups, _ = _kernel_breakdown(lambda: [fn() for _ in range(iters)])
    return sum(groups.values()) / iters


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


# K1's rows: the main path's bucket batches and the serve pack's 16 rows
ANCHOR_ROWS = (16, 64, 128, 256, 512, 1024)


def phase_anchor_match(records: dict) -> None:
    """K1 against its plain version, twice per case with the same bits, and
    timed in bf16 at every row count the paths launch it with (A = 129,
    D = 512, C = 2).  Its device time comes from the profiler: at B = 16 a
    launch takes less than the host needs to make it."""
    import torch

    from memvul_tpu_torch.ops import anchor_match as am

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(b, 129, 512, 2, bf16, 3e-2) for b in ANCHOR_ROWS] + [
        (16, 129, 512, 2, f32, 1e-5),
        (1024, 129, 512, 2, f32, 1e-5),
        (64, 129, 512, 2, f32, 1e-5),
        (17, 129, 200, 2, f32, 1e-5),
        (130, 5, 96, 2, f32, 1e-5),
        (5, 7, 64, 3, f32, 1e-5),
        (33, 40, 72, 4, bf16, 3e-2),
        (3, 1, 24, 1, f32, 1e-5),
        (9, 11, 66, 2, f32, 1e-5),  # D % 4 != 0: the element-wise staging
    ]
    results = []
    for b, a, d, c, dtype, tol in cases:
        u = torch.randn(b, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(a, d, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(3 * d, c, device="cuda", generator=gen) * 0.1).to(dtype)
        got = am.fused_anchor_match(u, v, w)
        again = am.fused_anchor_match(u, v, w)
        # the plain version on the same values in f64: in bf16 it would
        # round every intermediate, while the kernel accumulates in f32 and
        # rounds once (the JAX package's bf16 kernel test holds it the same
        # way); and an f32 plain version's own rounding over the 3·512
        # terms of an output is as large as the kernel's
        want = am.anchor_match_reference(u.double(), v.double(), w.double())
        torch.cuda.synchronize()
        err, ok = max_err(got, want, tol, tol)
        same_bits = bool(torch.equal(got, again))
        row = {"shape": [b, a, d, c], "dtype": str(dtype), "tol": tol,
               "max_abs_err": err, "same_bits_twice": same_bits, "ok": ok and same_bits}
        if dtype == bf16 and [a, d, c] == [129, 512, 2]:
            item = u.element_size()
            nbytes = (b * d + a * d + 3 * d * c + b * a * c) * item
            # one FADD and C FFMAs per (b, a, d) on the FP32 pipes
            slots = (c + 1) * b * a * d
            kernel = lambda: am.fused_anchor_match(u, v, w)  # noqa: E731
            row["kernel_ms"] = device_ms(kernel, 50)
            row["kernel_event_ms"] = time_ms(kernel, 50)
            row["plain_ms"] = time_ms(lambda: am.anchor_match_reference(u, v, w), 10)
            row["bound_ms"], row["bound_by"] = bound(nbytes, slots, F32_INSTRUCTIONS_PER_S)
            row["bound_rate"] = "FP32 instructions 33.5e12/s (67 TFLOP/s / 2), 3.35 TB/s"
        results.append(row)
        if not row["ok"]:
            emit("kernel_anchor_match", ok=False, cases=results)
            raise SystemExit(f"anchor-match kernel disagrees with its plain version: {row}")
    emit("kernel_anchor_match", ok=True, cases=results, card=nvidia_smi_line())
    shapes = {r["shape"][0]: r for r in results if "kernel_ms" in r}
    main = shapes[16]  # the shape almost every launch has (one per serve pack)
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
        "launches": 0,
        "shapes": shapes,
        "launches_by_rows": {},
    }


def emit_anchor_shapes(records: dict) -> None:
    """K1 at each row count beside its launches in the main path's and the
    serve path's runs, with the launch-weighted total."""
    rec = records["anchor_match"]
    rows = [{"rows": b, "launches": rec["launches_by_rows"].get(b, 0),
             **{k: r[k] for k in ("kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms", "bound_by")}}
            for b, r in sorted(rec["shapes"].items())]
    counted = sum(r["launches"] for r in rows)
    ok = counted == rec["launches"] and set(rec["launches_by_rows"]) <= set(rec["shapes"])
    emit("kernel_anchor_match_shapes", ok=ok, rows=rows, launches=counted,
         path_launches=rec["launches"], launches_by_rows=rec["launches_by_rows"],
         weighted_kernel_ms=sum(r["launches"] * r["kernel_ms"] for r in rows),
         weighted_bound_ms=sum(r["launches"] * r["bound_ms"] for r in rows),
         card=nvidia_smi_line())
    if not ok:
        raise SystemExit(f"anchor-match launches by rows {rec['launches_by_rows']} "
                         f"!= the paths' {rec['launches']}")


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


def main_path_bucket_rows() -> dict:
    """{length: rows} of the main path's batches: ``bucket_batch_sizes`` at
    ``tokens_per_batch``, as ``SiamesePredictor`` sizes them."""
    from memvul_tpu_torch.config import evaluation_config, load_config
    from memvul_tpu_torch.data.batching import bucket_batch_sizes

    ev = evaluation_config(load_config(CONFIG))
    return bucket_batch_sizes(ev["buckets"], int(ev["tokens_per_batch"]), multiple_of=8)


def main_path_flash_shapes() -> list:
    """[rows, length] of every K2 launch on ``main_path``, derived from the
    configuration through the port's own sizing: one batch shape per length
    bucket (``bucket_batch_sizes`` at ``tokens_per_batch``, as
    ``SiamesePredictor`` sizes them; the 4096 bucket is ``[64, 4096]``,
    which no synthetic report reaches, so only the warmup runs it) and the
    anchor bank's chunk
    (``anchor_chunk`` rows padded to ``evaluation.max_length``)."""
    import inspect

    from memvul_tpu_torch.config import evaluation_config, load_config
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    ev = evaluation_config(load_config(CONFIG))
    chunk = inspect.signature(SiamesePredictor).parameters["anchor_chunk"].default
    shapes = [[rows, length] for length, rows in sorted(main_path_bucket_rows().items())]
    bank = [chunk, int(ev["max_length"])]
    return shapes + ([bank] if bank not in shapes else [])


def train_flash_shapes() -> list:
    """[rows, length] of every K2 launch the train step can make: at each
    of the trainer's pow2 buckets up to ``max_length``, sample1's
    ``batch_size`` rows and a dedup'd sample2's fewer rows (each of
    ``dedup_capacities``, which ends at ``batch_size``)."""
    from memvul_tpu_torch.config import load_config
    from memvul_tpu_torch.data.batching import dedup_capacities, resolve_train_buckets

    tr = load_config(CONFIG)["trainer"]
    buckets = resolve_train_buckets(tr.get("train_buckets", "pow2"), int(tr["max_length"]))
    return [[rows, b] for rows in dedup_capacities(int(tr["batch_size"])) for b in buckets]


def _ptxas_report(kernel: str) -> dict:
    """What ptxas said about each instantiation of ``kernel`` (a template
    over one int) in this run's build, keyed by its template argument:
    registers, spill bytes, and whether it serialized the wgmmas
    (C7513/C7514, "wgmma ... serialized", which name the function)."""
    import re

    from memvul_tpu_torch.ops import _kernels

    lines = _kernels.build_log.splitlines()
    name = re.compile(rf"{kernel}ILi(\d+)E")
    out = {}
    for start, line in enumerate(lines):
        found = name.search(line)
        if not (found and "Compiling entry function" in line):
            continue
        block = []
        for later in lines[start + 1:]:
            if "Compiling entry function" in later:
                break
            block.append(later)
        text = " ".join(block)
        number = lambda pattern: int(re.search(pattern, text).group(1))  # noqa: E731
        arg = int(found.group(1))
        out[arg] = {
            "registers": number(r"Used (\d+) registers"),
            "spill_store_bytes": number(r"(\d+) bytes spill stores"),
            "spill_load_bytes": number(r"(\d+) bytes spill loads"),
            "wgmma_serialized": any("serialized" in l and f"{kernel}ILi{arg}E" in l for l in lines),
        }
    return out


def _check_ptxas(phase: str, report: dict) -> None:
    """A spill or a serialized wgmma fails the phase."""
    if any(p["spill_store_bytes"] or p["spill_load_bytes"] or p["wgmma_serialized"]
           for p in report.values()):
        emit(phase, ok=False, wgmma_ptxas=report)
        raise SystemExit(f"{phase}: a wgmma kernel spills or is serialized: {report}")


def _wgmma_ptxas() -> dict:
    """ptxas on the wgmma flash kernel's instantiations (2 and 3 consumer
    warpgroups), with each block's dynamic shared memory."""
    from memvul_tpu_torch.ops import _kernels

    report = _ptxas_report("flash_fwd_wgmma_kernel")
    if sorted(report) != [2, 3]:
        raise SystemExit(f"ptxas output lacks a wgmma flash instantiation: {sorted(report)}")
    return {f"consumers_{n}": dict(p, dynamic_smem_bytes=_kernels.library()
                                   .memvul_flash_fwd_wgmma_smem_bytes(n))
            for n, p in report.items()}


def phase_flash(records: dict) -> None:
    import torch
    import torch.nn.functional as F

    from memvul_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths_cpu = torch.Generator().manual_seed(2)

    def lengths(b, t):
        return torch.randint(1, t + 1, (b,), generator=lengths_cpu).tolist()

    ptxas = _wgmma_ptxas()
    _check_ptxas("kernel_flash", ptxas)
    # the main path's shapes, then the train step's
    main_shapes = main_path_flash_shapes()
    shapes = main_shapes + [s for s in train_flash_shapes() if s not in main_shapes]
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 with head dim 64 on 16-byte-aligned tensors takes the wgmma
    # kernel; f32, other head dims and unaligned views (pad 4) the
    # CUDA-core one.  The main path's shapes are timed.
    cases = [(b, t, 12, 64, bf16, 3e-2, lengths(b, t), 0) for b, t in shapes] + [
        # (B, T, H, D, dtype, tol, key lengths, view padding)
        (3, 300, 12, 64, bf16, 3e-2, [300, 173, 0], 0),  # row 2 fully masked
        (3, 300, 12, 64, bf16, 3e-2, [300, 173, 0], 4),
        (2, 37, 12, 64, bf16, 3e-2, [37, 5], 0),  # one partial key tile
        (2, 1, 12, 64, bf16, 3e-2, [1, 0], 0),    # T = 1; row 1 fully masked
        (2, 37, 4, 32, bf16, 3e-2, [37, 5], 0),
        (3, 300, 12, 64, f32, 2e-5, [300, 173, 0], 0),
        (2, 37, 4, 16, f32, 2e-5, [37, 5], 0),
    ]
    results = []
    for n, (b, t, h, d, dtype, tol, lens, pad) in enumerate(cases):
        q, k, v, bias = _flash_inputs(b, t, h, d, dtype, gen, lens, pad)
        got = fa.flash_attention(q, k, v, bias)
        want = fa.flash_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, tol, tol)
        row = {"shape": [b, t, h, d], "dtype": str(dtype), "view_pad": pad, "tol": tol,
               "max_abs_err": err, "ok": ok, "want_rms": rms(want), "err_over_rms": err / rms(want)}
        if n < len(shapes):
            # power of the check: the plain version with the first 128 keys
            # of every row masked must fail it (a kernel that lost a key tile)
            lost = bias.clone()
            lost[..., :128] = torch.finfo(bias.dtype).min
            row["lost_tile_err"], lost_ok = max_err(
                fa.flash_attention_reference(q, k, v, lost), want, tol, tol)
            if lost_ok:
                emit("kernel_flash", ok=False, cases=results + [row])
                raise SystemExit(f"the flash check cannot see a lost key tile: {row}")
            # the bf16 main-path launch runs the wgmma kernel (the name
            # also says how many consumer warpgroups this shape gets)
            top = []
            for _ in range(3):  # a profile that caught no device activity is taken again
                _, top = _kernel_breakdown(lambda: fa.flash_attention(q, k, v, bias))
                if top:
                    break
            row["kernel_name"] = top[0][0] if top else "no device activity profiled"
            if "flash_fwd_wgmma_kernel" not in row["kernel_name"]:
                emit("kernel_flash", ok=False, cases=results + [row])
                raise SystemExit(f"the main path's flash launch ran {row['kernel_name']}")
            item = q.element_size()
            nbytes = 4 * b * t * h * d * item + b * t * 4
            flops = 4 * b * h * t * t * d
            row["kernel_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, bias), 5)
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias), 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5
            )
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, BF16_TENSOR_FLOPS)
            row["bound_rate"] = "989 TFLOP/s bf16 tensor cores, 3.35 TB/s"
            row["kernel_tflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e12
            row["library_tflops"] = flops / (row["library_ms"] * 1e-3) / 1e12
            if [b, t] not in main_shapes:
                # the train step's shapes are small enough that CUDA events
                # around back-to-back calls time the host's launch path: the
                # kernels' own time is the profiler's
                row["kernel_device_ms"] = device_ms(lambda: fa.flash_attention(q, k, v, bias), 20)
                row["library_device_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 20)
            if [b, t] == [64, 4096]:
                # the CUDA-core kernel on the same values, through an unaligned view
                qs, ks, vs = (F.pad(x, (0, 4))[..., :d] for x in (q, k, v))
                row["cuda_core_kernel_ms"] = time_ms(lambda: fa.flash_attention(qs, ks, vs, bias), 2)
        del q, k, v, bias, got, want
        results.append(row)
        if not ok:
            emit("kernel_flash", ok=False, cases=results)
            raise SystemExit(f"flash kernel disagrees with its plain version: {row}")
    emit("kernel_flash", ok=True, wgmma_ptxas=ptxas, main_path_shapes=main_shapes,
         train_shapes=train_flash_shapes(), cases=results, card=nvidia_smi_line())
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
        # per timed shape, for the launches lines after main_path and train_path
        "shapes": {tuple(r["shape"][:2]): r for r in results[: len(shapes)]},
    }


def emit_flash_shapes(records: dict, bucket_batches: dict, anchor_chunks: int,
                      layers: int = 12, warm: bool = True) -> None:
    """K2 at each main-path shape beside its launches in ``main_path``'s
    run: ``layers`` per batch of a bucket, per anchor-bank chunk and, with
    ``warm``, per bucket shape's warmup run."""
    rec = records["flash_attention"]
    main_shapes = [tuple(s) for s in main_path_flash_shapes()]
    bank = main_shapes[-1]
    launches = {}
    for length in main_path_bucket_rows():
        count = int(bucket_batches.get(length, 0)) + (1 if warm else 0)
        shape = next(s for s in main_shapes if s[1] == int(length) and s != bank)
        launches[shape] = launches.get(shape, 0) + layers * count
    launches[bank] = launches.get(bank, 0) + layers * anchor_chunks
    rows = [{"shape": list(shape), "launches": launches.get(shape, 0),
             **{k: rec["shapes"][shape][k] for k in ("kernel_name", "kernel_ms", "library_ms",
                                                     "plain_ms", "bound_ms", "bound_by",
                                                     "kernel_tflops", "library_tflops")}}
            for shape in main_shapes]
    total = sum(r["launches"] for r in rows)
    ok = total == rec["launches"]
    emit("kernel_flash_shapes", ok=ok, rows=rows, launches=total,
         main_path_launches=rec["launches"], card=nvidia_smi_line())
    if not ok:
        raise SystemExit(f"flash launches by shape ({total}) != main_path's ({rec['launches']})")


# K2's gradients in bf16 against f32: the worst element's error over its
# (row, head)'s RMS.  The JAX design's backward rounds the scores to bf16;
# on the CPU, N(0, 1) inputs at the train shapes read 0.06 to 0.17
GRAD_ELEMENT_REL = 0.25


def phase_flash_grad() -> None:
    """K2 under autograd at the train step's shapes: ``[32, T, 12, 64]``
    bf16 for T in the trainer's buckets, with padded keys, and one dedup'd
    ``[8, 256, 12, 64]``.  The output must carry the autograd Function's
    ``grad_fn``, its forward must launch K2 once (the wgmma kernel among the
    profiled kernels), and the output and dq/dk/dv must match autograd
    through the plain version in f32: the output element by element at the
    bf16 tolerance ``kernel_flash`` uses (3e-2 absolute and relative); each
    gradient with a relative error ``||got − want|| / ||want||`` within the
    same 3e-2, and no element off by more than ``GRAD_ELEMENT_REL`` of its
    (row, head)'s RMS.  The backward recomputes through the plain
    ``xla_attention`` in the inputs' dtype, as the JAX package's does, so
    its scores round to bf16 before the softmax (the kernel keeps them in
    f32): q and k here are N(0, 1) (scores of spread 1, as a trained
    encoder's are), not ``kernel_flash``'s peaked 2·N(0, 1).  The check's
    power: the plain gradients with the padding mask dropped must fail it.
    The ragged wrapper must refuse a gradient."""
    import torch

    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.ops.attention import mask_to_bias

    gen = torch.Generator(device="cuda").manual_seed(11)
    lengths_cpu = torch.Generator().manual_seed(12)
    tol = 3e-2
    train = train_flash_shapes()
    rows = max(b for b, _ in train)
    shapes = [s for s in train if s[0] == rows] + [[8, 256]]

    def plain_grads(q, k, v, bias, g):
        ref_in = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        ref = fa.flash_attention_reference(*ref_in, bias.float())
        return ref.detach(), torch.autograd.grad(ref, ref_in, g.float())

    def grad_errs(got, want):
        errs, ok = {}, True
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            diff = a.float() - b
            rel = float(diff.norm() / b.norm())
            slice_rms = b.pow(2).mean(dim=(1, 3), keepdim=True).sqrt().clamp_min(1e-30)
            worst = float((diff.abs() / slice_rms).max())
            errs[f"{name}_rel_err"], errs[f"{name}_max_err_over_row_rms"] = rel, worst
            ok = ok and rel <= tol and worst <= GRAD_ELEMENT_REL and bool(torch.isfinite(a).all())
        return errs, ok

    results = []
    for b, t in shapes:
        lens = torch.randint(1, t + 1, (b,), generator=lengths_cpu).tolist()
        q, k, v = (torch.randn(b, t, 12, 64, device="cuda", generator=gen)
                   .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
        mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
        for i, n in enumerate(lens):
            mask[i, n:] = 0
        bias = mask_to_bias(mask, torch.bfloat16)
        before = fa.launches
        out = fa.flash_attention(q, k, v, bias)
        launched = fa.launches - before
        g = torch.randn(out.shape, device="cuda", generator=gen).to(out.dtype)
        grads = torch.autograd.grad(out, (q, k, v), g)
        ref, ref_grads = plain_grads(q, k, v, bias, g)
        torch.cuda.synchronize()
        row = {"shape": [b, t, 12, 64], "grad_fn": type(out.grad_fn).__name__,
               "forward_launches": launched}
        row["out_max_abs_err"], ok = max_err(out.detach(), ref, tol, tol)
        errs, g_ok = grad_errs(grads, ref_grads)
        row.update(errs)
        # power: the plain gradients without the padding mask must fail
        _, unmasked = plain_grads(q, k, v, torch.zeros_like(bias), g)
        unmasked_errs, unmasked_ok = grad_errs(unmasked, ref_grads)
        row["unmasked_grad_errs"] = unmasked_errs
        _, top = _kernel_breakdown(lambda: fa.flash_attention(q, k, v, bias))
        row["top_kernels"] = top[:3]
        ran_wgmma = any("flash_fwd_wgmma_kernel" in name for name, _ in top)
        row["ok"] = (ok and g_ok and not unmasked_ok and launched == 1 and ran_wgmma
                     and row["grad_fn"] == "FlashAttentionFunctionBackward")
        results.append(row)
        del q, k, v, out, grads, ref, ref_grads, unmasked
        if not row["ok"]:
            emit("kernel_flash_grad", ok=False, tol=tol, cases=results)
            raise SystemExit(f"K2 under autograd disagrees with the plain version: {row}")
    x = torch.zeros(1, 64, 12, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    try:
        ra.ragged_flash_attention(x, x, x, torch.ones(1, 64, dtype=torch.int32, device="cuda"))
        refused = False
    except RuntimeError:
        refused = True
    if not refused:
        raise SystemExit("the ragged wrapper returned a gradient-less output under autograd")
    emit("kernel_flash_grad", ok=True, tol=tol, grad_element_rel=GRAD_ELEMENT_REL,
         cases=results, ragged_refuses_grad=refused)


def _realistic_pack(budget: int, cap: int, max_rows: int = 16, seed: int = 0):
    """The fullest pack (the most rows, up to ``max_rows``) the serve path
    builds at ``budget`` from synthetic reports of realistic lengths
    (``generate_corpus(realistic_lengths=True)``, tokenized with a
    deterministic vocabulary and capped at ``cap``): its segment ids
    [1, budget] and its row lengths."""
    from memvul_tpu_torch.data.batching import collate_ragged, pack_token_budget
    from memvul_tpu_torch.data.synthetic import corpus_texts, generate_corpus
    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer

    reports, _ = generate_corpus(num_projects=16, reports_per_project=16, seed=seed,
                                 realistic_lengths=True)
    texts = corpus_texts(reports)
    tok = WordPieceTokenizer.build_deterministic(texts, vocab_size=30522)
    seqs = [tok.encode(t, max_length=cap) for t in texts]
    pack = max(pack_token_budget([len(s) for s in seqs], budget, max_rows), key=len)
    sample = collate_ragged([seqs[i] for i in pack], budget, max_rows, tok.pad_id)
    return sample["segment_ids"], [len(seqs[i]) for i in pack]


def _random_layout(b: int, t: int, seed: int):
    """Segment ids in no order and with gaps: runs of random lengths whose
    ids are drawn from {0, 2, 3, 5, 7, 11} (0 = dead), as the JAX
    package's random-layout tests and aliased packs can give."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        offset = 0
        while offset < t:
            n = int(rng.integers(1, 90))
            seg[i, offset : offset + n] = rng.choice([0, 2, 3, 5, 7, 11])
            offset += n
    return seg


def _masked_attention(q, k, v, allowed):
    """The plain version's arithmetic under an arbitrary [B, T, T] mask:
    what a kernel that leaked across requests, or lost a key tile, would
    give (dense, for the serve path's T = 2048)."""
    import math

    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    s = torch.where(allowed[:, None], s, torch.finfo(torch.float32).min)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (pv / p.sum(-1).clamp_min(1e-30).permute(0, 2, 1)[..., None]).to(q.dtype)


def _stress_layout(t: int = 2048):
    """One 512-token request among short ones, request boundaries in the
    middle of 64-position tiles, and the last ten tiles dead: ids 1, 2, ...
    end to end as the packer lays them out."""
    import numpy as np

    lengths = [37, 100, 45, 512, 23, 150, 77, 300, 5, 61, 90]
    seg = np.zeros((1, t), np.int32)
    offset = 0
    for i, n in enumerate(lengths):
        seg[0, offset : offset + n] = i + 1
        offset += n
    return seg


def phase_ragged(records: dict) -> None:
    """K3 against its plain version on live rows; every output element
    written (the output's block is poisoned with NaN just before the call);
    the device's tile-range table equal to its plain version; the check
    shown to catch a leak across requests and a lost key tile; and ptxas's
    report on the wgmma kernel (a spill or a serialized wgmma fails)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from memvul_tpu_torch.ops import ragged_attention as ra

    ptxas = _ptxas_report("ragged_fwd_wgmma_kernel")
    if len(ptxas) != 1:
        raise SystemExit(f"ptxas output lacks the one wgmma ragged instantiation: {sorted(ptxas)}")
    _check_ptxas("kernel_ragged", ptxas)
    gen = torch.Generator(device="cuda").manual_seed(4)
    serve_seg, serve_lens = _realistic_pack(2048, 512)
    long_seg, long_lens = _realistic_pack(16384, 4096)
    cases = [
        # (name, segment ids [B, T], H, D, dtype, tol)
        ("serve_pack", serve_seg, 12, 64, torch.bfloat16, 3e-2),
        ("long_pack", long_seg, 12, 64, torch.bfloat16, 3e-2),
        ("stress", _stress_layout(), 12, 64, torch.bfloat16, 3e-2),
        ("random_layout_bf16", _random_layout(2, 300, seed=5), 12, 64, torch.bfloat16, 3e-2),
        ("random_layout_f32", _random_layout(2, 160, seed=6), 4, 32, torch.float32, 2e-5),
    ]
    results = []
    for name, seg_np, h, d, dtype, tol in cases:
        b, t = seg_np.shape
        seg = torch.as_tensor(seg_np, device="cuda")
        q, k, v = ((torch.randn(b, t, h, d, device="cuda", generator=gen) * scale).to(dtype)
                   for scale in (2.0, 2.0, 1.0))
        packed = ra.pack_segments(seg)
        ranges_ok = bool(torch.equal(packed.tile_ranges, ra.tile_ranges_reference(seg)))
        # the caching allocator hands the NaN block back as the output's, so
        # an element the kernel never writes stays NaN
        poison = torch.full((b, t, h, d), float("nan"), dtype=dtype, device="cuda")
        poisoned_ptr = poison.data_ptr()
        del poison
        got = ra.ragged_flash_attention(q, k, v, packed)
        want = ra.ragged_flash_attention_reference(q, k, v, seg)
        torch.cuda.synchronize()
        live = seg > 0
        err, ok = max_err(got[live], want[live], tol, tol)
        all_finite = bool(torch.isfinite(got.float()).all())
        poisoned = got.data_ptr() == poisoned_ptr
        seg_tokens = [int(n) for n in np.unique(seg_np[seg_np > 0], return_counts=True)[1]] \
            if b == 1 else None
        row = {"case": name, "shape": [b, t, h, d], "dtype": str(dtype), "tol": tol,
               "max_abs_err": err, "ok": ok and all_finite and poisoned and ranges_ok,
               "all_outputs_finite": all_finite, "output_block_poisoned": poisoned,
               "tile_ranges_equal_plain": ranges_ok,
               "live_tokens": int(live.sum()), "want_rms": rms(want[live])}
        if name in ("serve_pack", "long_pack"):
            item = q.element_size()
            # dense work reads q, k, v at every position; segment work needs
            # them only at the live tokens (dead ones are never seen), and
            # both write out at every position and read the segment ids once
            dense_bytes = 4 * t * h * d * item + t * 4
            seg_bytes = (3 * row["live_tokens"] + t) * h * d * item + t * 4
            dense_flops = 4 * h * t * t * d
            seg_flops = 4 * h * sum(n * n for n in seg_tokens) * d
            row["rows"] = len(seg_tokens)
            row["row_tokens"] = serve_lens if name == "serve_pack" else long_lens
            row["dense_bound_ms"], row["dense_bound_by"] = bound(dense_bytes, dense_flops, BF16_TENSOR_FLOPS)
            row["segment_bound_ms"], row["segment_bound_by"] = bound(seg_bytes, seg_flops, BF16_TENSOR_FLOPS)
            row["bound_rate"] = "989 TFLOP/s bf16 tensor cores, 3.35 TB/s"
            # a pack's kernel runs for tens of microseconds, less than the
            # host takes to launch it, so back-to-back CUDA events time the
            # launches; its own time, and SDPA's, come from the profiler.
            # The tile table is built once per pack (not per layer), and is
            # timed on its own
            kernel = lambda: ra.ragged_flash_attention(q, k, v, packed)  # noqa: E731
            top = []
            for _ in range(3):  # a profile that caught no device activity is taken again
                _, top = _kernel_breakdown(kernel)
                if top:
                    break
            row["kernel_name"] = top[0][0] if top else "no device activity profiled"
            if "ragged_fwd_wgmma_kernel" not in row["kernel_name"]:
                emit("kernel_ragged", ok=False, cases=results + [row])
                raise SystemExit(f"the serve path's ragged launch ran {row['kernel_name']}")
            row["kernel_event_ms"] = time_ms(kernel, 20)
            row["kernel_ms"] = device_ms(kernel, 20)
            row["tile_ranges_ms_per_pack"] = device_ms(lambda: ra.pack_segments(seg), 20)
            row["plain_ms"] = time_ms(lambda: ra.ragged_flash_attention_reference(q, k, v, seg), 2)
            mask = ra.segment_bias(seg, dtype)  # [1, 1, T, T], never used by the port
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
            row["library_event_ms"] = time_ms(sdpa, 5)
            row["library_ms"] = device_ms(sdpa, 5)
            del mask
        if name in ("serve_pack", "stress"):
            # power of the check: a kernel that leaked across requests (the
            # pack's padding mask instead of its segments) or lost the first
            # key tile of every segment must fail it
            same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
            pad_only = live[:, :, None] & live[:, None, :]
            first = torch.zeros_like(live)
            for s_id in torch.unique(seg[live]).tolist():
                first[0, torch.nonzero(seg[0] == s_id)[:64, 0]] = True
            lost = same & ~first[:, None, :]
            for key, allowed in (("leak_err", pad_only), ("lost_tile_err", lost)):
                row[key], caught_ok = max_err(_masked_attention(q, k, v, allowed)[live],
                                              want[live], tol, tol)
                if caught_ok:
                    emit("kernel_ragged", ok=False, cases=results + [row])
                    raise SystemExit(f"the ragged check cannot see a {key[:-4]}: {row}")
        del q, k, v, got, want
        results.append(row)
        if not row["ok"]:
            emit("kernel_ragged", ok=False, cases=results)
            raise SystemExit(f"ragged kernel disagrees with its plain version: {row}")
    emit("kernel_ragged", ok=True, wgmma_ptxas=ptxas, cases=results, card=nvidia_smi_line())
    main = results[0]
    records["ragged_flash_attention"] = {
        "name": "ragged_flash_attention",
        "route": "cuda",
        "source": "memvul_tpu_torch/csrc/ragged_fwd.cu",
        "replaces": "memvul_tpu/ops/pallas/ragged_attention.py:135",
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        # the work this pack's data needs: pairs inside one segment
        "bound_ms": main["segment_bound_ms"],
        "bound_by": main["segment_bound_by"],
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


def _write_corpus(workdir: Path, reports_wanted: int):
    """The main path's data in ``workdir``: a synthetic corpus of realistic
    lengths (``test_project.json``, ``CVE_dict.json``), 129 anchors
    (``CWE_anchor_golden_project.json``) and a deterministic vocabulary
    (``vocab.txt``).  Returns (reports, anchors, tokenizer, the config
    with the reader pointed at these files)."""
    from memvul_tpu_torch.config import load_config
    from memvul_tpu_torch.data.synthetic import corpus_texts, generate_corpus
    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer

    cfg = load_config(CONFIG)
    per_project = 32
    reports, cve = generate_corpus(
        num_projects=max(1, reports_wanted // per_project),
        reports_per_project=per_project, seed=0, realistic_lengths=True,
    )
    anchors = _synthetic_anchors(129, seed=1)
    (workdir / "test_project.json").write_text(json.dumps(reports))
    cve_path = workdir / "CVE_dict.json"
    cve_path.write_text(json.dumps(cve))
    anchor_path = workdir / "CWE_anchor_golden_project.json"
    anchor_path.write_text(json.dumps(anchors))
    tok = WordPieceTokenizer.build_deterministic(
        corpus_texts(reports) + list(anchors.values()), vocab_size=30522
    )
    tok.save_vocab_txt(workdir / "vocab.txt")
    cfg["dataset_reader"] = dict(cfg["dataset_reader"], cve_path=str(cve_path),
                                 anchor_path=str(anchor_path))
    return reports, anchors, tok, cfg


def phase_main_path(workdir: Path, records: dict, reports_wanted: int = 512) -> None:
    import numpy as np
    import torch

    from memvul_tpu_torch.archive import save_archive
    from memvul_tpu_torch.build import evaluate_from_archive
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    reports, anchors, tok, cfg = _write_corpus(workdir, reports_wanted)
    test_path = workdir / "test_project.json"
    vocab_path = workdir / "vocab.txt"
    # the synthetic corpus has a few hundred distinct words; the embedding
    # table keeps bert-base's 30522 rows all the same
    model_cfg = dict(cfg["model"], encoder=dict(cfg["model"]["encoder"], vocab_size=30522))
    archived = dict(cfg, model=model_cfg)
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
    # aot_warmup (on by default) runs every stream shape once before scoring
    warm = "s_warmup_s" in metrics
    shapes = len(metrics["s_stream_shapes"]) if warm else 0
    layers = 12
    if flash_launches != layers * (shapes + batches + chunks) or match_launches != shapes + batches:
        raise SystemExit(
            f"launch counts off: flash {flash_launches} (want "
            f"{layers * (shapes + batches + chunks)}), anchor_match {match_launches} "
            f"(want {shapes + batches})"
        )
    anchor = records["anchor_match"]
    anchor["launches"] += match_launches
    rows = main_path_bucket_rows()
    for length, b in rows.items():
        count = int(metrics["s_bucket_batches"].get(length, 0)) + (1 if warm else 0)
        if count:
            anchor["launches_by_rows"][b] = anchor["launches_by_rows"].get(b, 0) + count
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
        warmup_s=metrics.get("s_warmup_s"),
        peak_memory_gib=peak_bytes / 2**30, f1=saved["f1"], auc=saved["auc"],
        card=nvidia_smi_line(),
    )
    emit_flash_shapes(records, metrics["s_bucket_batches"], chunks, layers, warm)


# -- the reference's evaluation override files, the int8 tier, resume -----------

# the JAX package's own drift bound for the int8 tier: the largest
# |Δ best-anchor probability| between the int8 and the full-precision
# scoring of the same reports (tests/test_quant.py,
# test_quant_memory_model_scoring_decision_stability)
INT8_BEST_PROB_DRIFT = 0.15
# the JAX package's bound on the int8 encoder's output against the
# full-precision encoder's on the same weights: their correlation
# (tests/test_quant.py, test_quant_encoder_shares_checkpoints_and_tracks_f32)
INT8_ENCODER_CORR = 0.99
# the dynamic int8 linear against bf16 F.linear on N(0, 1) inputs and
# N(0, 0.02) weights: max |Δ| / max |bf16| (dynamic int8's own rounding is
# about 0.011-0.013 at the encoder's projections; a wrong weight scale of
# one column in 768 reads 0.29-0.43 there)
INT8_LINEAR_REL_ERR = 0.05
HAND_BUCKETS = (64, 128, 256, 512)


def _corpus_lengths(tok, test_path: Path, max_length: int) -> list:
    """Token lengths of the corpus's reports at ``max_length``, as the
    scoring path reads (with the CVE records beside the corpus) and
    encodes them."""
    from memvul_tpu_torch.data.readers import MemoryReader

    reader = MemoryReader(cve_path=str(test_path.parent / "CVE_dict.json"))
    texts = [inst["text1"] for inst in reader.read(str(test_path), split="test")]
    return [len(ids) for ids in tok.encode_many(texts, max_length=max_length)]


def _bucket_tokens(lengths: list, buckets, tokens_per_batch: int) -> dict:
    """What a bucket set makes of the corpus: each report padded to its
    bucket (live tokens) and each bucket's batches padded to their full
    row count (slots, dead rows included)."""
    from memvul_tpu_torch.data.batching import bucket_batch_sizes

    rows = bucket_batch_sizes(buckets, tokens_per_batch, multiple_of=8)
    counts = {b: 0 for b in buckets}
    for n in lengths:
        counts[next(b for b in sorted(buckets) if b >= n)] += 1
    return {
        "buckets": list(buckets),
        "real_tokens": int(sum(lengths)),
        "padded_tokens": int(sum(b * c for b, c in counts.items())),
        "slot_tokens": int(sum(-(-c // rows[b]) * rows[b] * b for b, c in counts.items())),
        "batches": int(sum(-(-c // rows[b]) for b, c in counts.items())),
    }


def _result_records(path: Path) -> list:
    return [r for line in path.read_text().splitlines() if line.strip() for r in json.loads(line)]


def _flash_at_auto_shapes(shapes: list, records: dict) -> list:
    """K2 against its plain version at each (rows, length) a run launched
    it with.  Every row's first keys are scaled up 3x, so they dominate any
    softmax that sees them: a kernel whose last, partial key tile read past
    Tk into the next sequence's keys would move the outputs far beyond the
    tolerance.  The phase computes that leak with the plain version (keys
    of sequence i extended by those of sequence i + 1 up to the 128-key
    tile) and requires it to fail the check wherever T % 128 != 0.  The
    values stay N(0, 1), so the bf16 check's tolerance keeps its scale."""
    import torch

    from memvul_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    lengths_cpu = torch.Generator().manual_seed(7)
    tol, tile = 3e-2, 128
    out = []
    for rows, t in shapes:
        lens = [t if i % 2 == 0 else int(torch.randint(1, t + 1, (1,), generator=lengths_cpu))
                for i in range(rows)]
        q, k, v, bias = _flash_inputs(rows, t, 12, 64, torch.bfloat16, gen, lens)
        ext = (-t) % tile
        if ext:
            k[:, :ext] *= 3.0
        got = fa.flash_attention(q, k, v, bias)
        want = fa.flash_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, tol, tol)
        row = {"shape": [rows, t, 12, 64], "t_mod_64": t % 64, "max_abs_err": err, "ok": ok,
               "want_rms": rms(want)}
        if ext:
            n = min(rows - 1, 16) // 2 * 2  # even rows 0..n-2, each with its successor's keys
            idx = torch.arange(0, n, 2, device="cuda")
            k_leak = torch.cat([k[idx], k[idx + 1, :ext]], dim=1)
            v_leak = torch.cat([v[idx], v[idx + 1, :ext]], dim=1)
            b_leak = torch.cat([bias[idx], bias[idx + 1][..., :ext]], dim=-1)
            leak = fa.flash_attention_reference(q[idx], k_leak, v_leak, b_leak)
            row["leak_err"], leak_ok = max_err(leak, want[idx], tol, tol)
            row["ok"] = ok and not leak_ok
        item = q.element_size()
        row["kernel_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, bias), 5)
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias), 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5)
        row["bound_ms"], row["bound_by"] = bound(4 * rows * t * 12 * 64 * item + rows * t * 4,
                                                 4 * rows * 12 * t * t * 64, BF16_TENSOR_FLOPS)
        del q, k, v, bias, got, want
        out.append(row)
        if not row["ok"]:
            emit("kernel_flash_auto_shapes", ok=False, cases=out)
            raise SystemExit(f"flash kernel at an auto-bucket shape: {row}")
    return out


def _anchor_match_at_rows(row_counts, a: int = 129) -> list:
    """K1 against its plain version (f64) at each row count, ``a`` anchors
    (129: the main path's bank), D = 512, C = 2, bf16, twice for the same
    bits; timed as ``phase_anchor_match`` times it (profiler device time),
    beside the plain version's time and the FP32-instruction bound."""
    import torch

    from memvul_tpu_torch.ops import anchor_match as am

    gen = torch.Generator(device="cuda").manual_seed(8)
    d, c = 512, 2
    out = []
    for b in sorted(set(row_counts)):
        u = torch.randn(b, d, device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn(a, d, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(3 * d, c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        got, again = am.fused_anchor_match(u, v, w), am.fused_anchor_match(u, v, w)
        want = am.anchor_match_reference(u.double(), v.double(), w.double())
        torch.cuda.synchronize()
        err, ok = max_err(got, want, 3e-2, 3e-2)
        row = {"rows": b, "anchors": a, "max_abs_err": err,
               "same_bits_twice": bool(torch.equal(got, again)),
               "ok": ok and bool(torch.equal(got, again))}
        if not row["ok"]:
            raise SystemExit(f"anchor-match kernel at an auto-bucket row count: {row}")
        nbytes = (b * d + a * d + 3 * d * c + b * a * c) * u.element_size()
        row["kernel_ms"] = device_ms(lambda: am.fused_anchor_match(u, v, w), 20)
        row["plain_ms"] = time_ms(lambda: am.anchor_match_reference(u, v, w), 3)
        row["bound_ms"], row["bound_by"] = bound(nbytes, (c + 1) * b * a * d, F32_INSTRUCTIONS_PER_S)
        out.append(row)
    return out


def _evaluate_counted(archive: Path, test_path: Path, out_dir: Path, overrides):
    """``evaluate_from_archive`` on the card with the launch counts set to
    0 just before it and read just after: (metrics, wall s, peak GiB,
    {kernel: launches}, int8 GEMMs)."""
    import torch

    from memvul_tpu_torch.build import evaluate_from_archive
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import quant

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = am.launches = quant.calls = 0
    t0 = time.perf_counter()
    metrics = evaluate_from_archive(archive, test_path, out_dir, overrides=overrides, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "anchor_match": am.launches}
    return metrics, wall, torch.cuda.max_memory_allocated() / 2**30, launches, quant.calls


def _check_path_launches(phase: str, metrics: dict, launches: dict, layers: int = 12) -> dict:
    """K2 runs in every layer of every forward (warmup shapes, batches,
    anchor chunks) and K1 once per scored block: the counts the run must
    show, by shape."""
    warm = len(metrics["s_stream_shapes"]) if "s_warmup_s" in metrics else 0
    batches, chunks = int(metrics["s_batches"]), int(metrics["s_anchor_chunks"])
    want = {"flash_attention": layers * (warm + batches + chunks), "anchor_match": warm + batches}
    if launches != want:
        raise SystemExit(f"{phase}: launch counts {launches}, want {want}")
    rows = {length: r for r, length in metrics["s_stream_shapes"]}
    by_shape = {f"{rows[length]}x{length}": layers * (int(count) + (1 if warm else 0))
                for length, count in metrics["s_bucket_batches"].items()}
    for r, length in metrics["s_stream_shapes"]:
        by_shape.setdefault(f"{r}x{length}", layers if warm else 0)
    by_shape["128x512 (anchor bank)"] = layers * chunks
    return by_shape


def phase_main_path_auto(workdir: Path, records: dict) -> dict:
    """``evaluate_from_archive`` over the main path's corpus with
    ``configs/test_config_memory.json``'s text verbatim as the overrides
    (auto-8 buckets at max_length 512, 262144 tokens a batch, warmup of
    every stream shape), then K2 and K1 held against their plain versions
    at the shapes the run launched them with."""
    import numpy as np

    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer

    archive, test_path = workdir / "model.tar.gz", workdir / "test_project.json"
    overrides = (ROOT / "configs" / "test_config_memory.json").read_text()
    metrics, wall, peak, launches, _ = _evaluate_counted(archive, test_path, workdir / "eval_auto",
                                                         overrides)
    by_shape = _check_path_launches("main_path_auto", metrics, launches)
    shapes = [list(s) for s in metrics["s_stream_shapes"]]
    auto = [length for _, length in shapes]
    tok = WordPieceTokenizer(vocab_path=str(workdir / "vocab.txt"))
    lengths = _corpus_lengths(tok, test_path, 512)
    recs = _result_records(workdir / "eval_auto" / "model_memory_result.json")
    probs = np.array([list(r["predict"].values()) for r in recs])
    if len(recs) != len(lengths) or probs.shape[1] != 129 or not np.isfinite(probs).all():
        raise SystemExit(f"main_path_auto wrote {len(recs)} records of shape {probs.shape}")
    slots = sum(int(metrics["s_bucket_row_slots"][length]) * int(length)
                for length in metrics["s_bucket_row_slots"])
    auto_tokens = _bucket_tokens(lengths, auto, 262144)
    if auto_tokens["slot_tokens"] != slots:
        raise SystemExit(f"main_path_auto padded {slots} slot tokens, the sizing says {auto_tokens}")
    flash = _flash_at_auto_shapes(shapes, records)
    if not any(r["t_mod_64"] and "leak_err" in r for r in flash):
        raise SystemExit(f"no auto shape with T % 64 != 0 was held against the plain version: {auto}")
    anchor = _anchor_match_at_rows([r for r, _ in shapes])
    emit("main_path_auto", ok=True, config="configs/test_config_memory.json (verbatim)",
         reports=len(recs), auto_buckets=auto, stream_shapes=shapes,
         tokens={"auto": auto_tokens, "hand": _bucket_tokens(lengths, HAND_BUCKETS, 262144)},
         wall_s=wall, warmup_s=metrics["s_warmup_s"],
         reports_per_s=len(recs) / metrics["s_elapsed_s"], scoring_s=metrics["s_elapsed_s"],
         anchor_encode_s=metrics["s_anchor_encode_s"], bucket_seconds=metrics["s_bucket_seconds"],
         bucket_batches=metrics["s_bucket_batches"], launches=launches,
         flash_launches_by_shape=by_shape, peak_memory_gib=peak, f1=metrics["f1"],
         auc=metrics["auc"], card=nvidia_smi_line())
    emit("kernel_flash_auto_shapes", ok=True, cases=flash, tol=3e-2, card=nvidia_smi_line())
    # K1's launches in this run by row count: each shape's batches, and its warmup
    warm = 1 if "s_warmup_s" in metrics else 0
    for row in anchor:
        row["launches"] = sum(int(metrics["s_bucket_batches"].get(length, 0)) + warm
                              for r, length in shapes if r == row["rows"])
    emit("kernel_anchor_match_auto_rows", ok=True, cases=anchor, tol=3e-2, card=nvidia_smi_line())
    records["flash_attention"]["launches"] += launches["flash_attention"]
    records["anchor_match"]["launches"] += launches["anchor_match"]
    return metrics


class _planted_fault:
    """A deliberate fault in the int8 tier, for as long as the ``with``
    lasts, to show that a gate catches it: ``"weight_scale"`` dequantizes
    each output column with its neighbour's weight scale, ``"layout"``
    hands the card's int8 GEMM the weight codes [N, K] read as [K, N]."""

    def __init__(self, kind: str) -> None:
        self.kind = kind

    def __enter__(self):
        import torch

        from memvul_tpu_torch.ops import quant

        self.saved = quant._dequantize, quant._int_mm
        dequantize, int_mm = self.saved
        if self.kind == "weight_scale":
            quant._dequantize = lambda acc, xs, ws, dt: dequantize(acc, xs, ws.roll(1), dt)
        elif self.kind == "layout":
            quant._int_mm = lambda a, b_t: int_mm(a, b_t.contiguous().view(a.shape[1], -1).t())
        else:
            raise ValueError(self.kind)
        return self

    def __exit__(self, *exc):
        from memvul_tpu_torch.ops import quant

        quant._dequantize, quant._int_mm = self.saved
        return False


def _corr(a, b) -> float:
    """Pearson correlation of two tensors' elements, in f64."""
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a @ b) / (a.norm() * b.norm()))


def _int8_encoder_check(workdir: Path, reports: int = 64) -> dict:
    """The int8 encoder against the bf16 encoder on the main path's archive
    (the same weights) and the corpus's first ``reports`` reports at 512
    tokens: the correlation of the last hidden states over real tokens and
    of the pooled embeddings.  The hidden states are gated by the JAX
    package's bound (``INT8_ENCODER_CORR``), and each planted fault must
    fall below it."""
    import itertools

    import torch

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.evaluate.predict_memory import _int8_twin

    arch = load_archive(workdir / "model.tar.gz", device="cuda")
    reader = MemoryReader(cve_path=str(workdir / "CVE_dict.json"))
    texts = [inst["text1"] for inst in
             itertools.islice(reader.read(str(workdir / "test_project.json"), split="test"), reports)]
    encoded = arch.tokenizer.encode_many(texts, max_length=512)
    t = -(-max(len(e) for e in encoded) // 8) * 8
    ids = torch.zeros(len(encoded), t, dtype=torch.long)
    mask = torch.zeros(len(encoded), t, dtype=torch.int32)
    for i, e in enumerate(encoded):
        ids[i, :len(e)] = torch.tensor(e)
        mask[i, :len(e)] = 1
    ids, mask = ids.cuda(), mask.cuda()
    real = mask.bool()
    model = arch.model.eval()
    twin = _int8_twin(model)
    with torch.no_grad():
        hidden, pooled = model.bert(ids, mask)[real], model.encode(ids, mask)
        out = {"reports": len(encoded), "length": t, "real_tokens": int(real.sum()),
               "hidden_corr": _corr(hidden, twin.bert(ids, mask)[real]),
               "pooled_corr": _corr(pooled, twin.encode(ids, mask)), "planted": {}}
        for kind in ("weight_scale", "layout"):
            with _planted_fault(kind):
                out["planted"][kind] = _corr(hidden, twin.bert(ids, mask)[real])
    torch.cuda.synchronize()
    del arch, model, twin
    torch.cuda.empty_cache()
    out["ok"] = bool(out["hidden_corr"] > INT8_ENCODER_CORR
                     and all(c <= INT8_ENCODER_CORR for c in out["planted"].values()))
    return out


def phase_main_path_int8(workdir: Path, records: dict, bf16_metrics: dict) -> None:
    """The same corpus with ``configs/test_config_memory_int8.json``
    verbatim (the encoder's six projections a layer in dynamic int8),
    against the bf16 run of ``main_path_auto``: the largest |Δ best
    probability| (gated by the JAX package's drift bound), the decisions
    that flip at 0.5, and both runs' ``cal_metrics``; then the int8
    encoder's output against bf16's (``_int8_encoder_check``)."""
    import numpy as np

    archive, test_path = workdir / "model.tar.gz", workdir / "test_project.json"
    overrides = (ROOT / "configs" / "test_config_memory_int8.json").read_text()
    metrics, wall, peak, launches, gemms = _evaluate_counted(archive, test_path,
                                                             workdir / "eval_int8", overrides)
    by_shape = _check_path_launches("main_path_int8", metrics, launches)
    forwards = len(metrics["s_stream_shapes"]) + int(metrics["s_batches"]) + int(metrics["s_anchor_chunks"])
    if gemms != 6 * 12 * forwards:
        raise SystemExit(f"main_path_int8 ran {gemms} int8 GEMMs, want 6 x 12 x {forwards}")
    best = {}
    for name in ("eval_auto", "eval_int8"):
        best[name] = {r["Issue_Url"]: max(r["predict"].values())
                      for r in _result_records(workdir / name / "model_memory_result.json")}
    urls = sorted(best["eval_auto"])
    if sorted(best["eval_int8"]) != urls:
        raise SystemExit("main_path_int8 scored another set of reports than main_path_auto")
    b16 = np.array([best["eval_auto"][u] for u in urls])
    i8 = np.array([best["eval_int8"][u] for u in urls])
    drift = float(np.abs(i8 - b16).max())
    keys = ["TP", "FN", "TN", "FP", "pd&recall", "prec", "f1", "ap", "auc", "thres"]
    encoder = _int8_encoder_check(workdir)
    ok = np.isfinite(i8).all() and drift < INT8_BEST_PROB_DRIFT and encoder["ok"]
    emit("main_path_int8", ok=bool(ok), config="configs/test_config_memory_int8.json (verbatim)",
         reports=len(urls), reports_per_s=len(urls) / metrics["s_elapsed_s"],
         bf16_reports_per_s=len(urls) / bf16_metrics["s_elapsed_s"],
         scoring_s=metrics["s_elapsed_s"], wall_s=wall, warmup_s=metrics["s_warmup_s"],
         anchor_encode_s=metrics["s_anchor_encode_s"], bucket_seconds=metrics["s_bucket_seconds"],
         peak_memory_gib=peak, best_prob_max_abs_diff=drift, drift_bound=INT8_BEST_PROB_DRIFT,
         encoder_vs_bf16=encoder, encoder_corr_bound=INT8_ENCODER_CORR,
         decision_flips_at_0_5=int(((i8 >= 0.5) != (b16 >= 0.5)).sum()),
         best_prob_mean={"bf16": float(b16.mean()), "int8": float(i8.mean())},
         cal_metrics={"bf16": {k: bf16_metrics[k] for k in keys}, "int8": {k: metrics[k] for k in keys}},
         launches=launches, flash_launches_by_shape=by_shape, int8_gemms=gemms,
         card=nvidia_smi_line())
    if not ok:
        raise SystemExit(f"main_path_int8: best-probability drift {drift} (bound "
                         f"{INT8_BEST_PROB_DRIFT}) or the encoder against bf16 {encoder} (bound "
                         f"{INT8_ENCODER_CORR}, each planted fault at or below it)")
    records["flash_attention"]["launches"] += launches["flash_attention"]
    records["anchor_match"]["launches"] += launches["anchor_match"]


def phase_int8_linear(batch_rows=(262144, 2048)) -> None:
    """The dynamic int8 linear (quantize the activations, ``torch._int_mm``,
    dequantize) against bf16 ``F.linear`` at the encoder's four projections,
    at a full batch (M = 262144, CUDA events) and a serve pack (M = 2048,
    the profiler's device time), with each part's time; the ``"int8"``
    mode (weights quantized once) must give the dynamic mode's bits.
    Gated: the card's int32 products equal an f64 product of the same
    codes (sampled rows here, every row at the padded shapes of
    ``_int_mm_exact_cases``), the error against bf16 stays under
    ``INT8_LINEAR_REL_ERR``, and each planted fault breaks a gate."""
    import torch
    import torch.nn.functional as F

    from memvul_tpu_torch.ops import quant

    INT8_OPS = 1979e12  # dense int8 tensor-core operations a second
    gen = torch.Generator(device="cuda").manual_seed(9)
    projections = [("query/key/value (x3 a layer)", 768, 768), ("attention output", 768, 768),
                   ("intermediate", 768, 3072), ("output", 3072, 768)]
    rows = []
    for m in batch_rows:
        timer = (lambda fn: time_ms(fn, 5)) if m > 16384 else (lambda fn: device_ms(fn, 20))
        for name, k, n in projections:
            x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
            layer = {mode: quant.QuantLinear(k, n, mode).to("cuda") for mode in quant.QUANT_MODES}
            with torch.no_grad():
                torch.nn.init.normal_(layer["int8_dynamic"].weight, std=0.02, generator=gen)
                layer["int8"].load_state_dict(layer["int8_dynamic"].state_dict())
                dyn = layer["int8_dynamic"].quantized(x, torch.bfloat16)
                pre = layer["int8"].quantized(x, torch.bfloat16)
                ref = F.linear(x, layer["int8_dynamic"].weight.to(torch.bfloat16),
                               layer["int8_dynamic"].bias.to(torch.bfloat16))
                torch.cuda.synchronize()
                same = bool(torch.equal(dyn, pre))
                rel = float((dyn.float() - ref.float()).abs().max() / ref.float().abs().max())
                w = layer["int8"].weight
                xq, xs = quant.quantize_rowwise(x)
                wq, ws = layer["int8"].quantized_weight()
                acc = quant._int_mm(xq, wq)
                exact = _int_mm_matches_f64(xq, wq, acc)
                planted = {}
                for kind in ("weight_scale", "layout"):
                    with _planted_fault(kind):
                        bad = layer["int8_dynamic"].quantized(x, torch.bfloat16)
                        planted[kind] = {
                            "max_rel_err_vs_bf16": float((bad.float() - ref.float()).abs().max()
                                                         / ref.float().abs().max()),
                            "int32_exact": _int_mm_matches_f64(xq, wq, quant._int_mm(xq, wq)),
                        }
                    del bad
                row = {
                    "projection": name, "m": m, "k": k, "n": n, "int8_modes_same_bits": same,
                    "int32_exact": exact, "max_rel_err_vs_bf16": rel, "planted_faults": planted,
                    "bf16_linear_ms": timer(lambda: F.linear(x, w.to(torch.bfloat16),
                                                             layer["int8"].bias.to(torch.bfloat16))),
                    "int8_dynamic_ms": timer(lambda: layer["int8_dynamic"].quantized(x, torch.bfloat16)),
                    "int8_cached_ms": timer(lambda: layer["int8"].quantized(x, torch.bfloat16)),
                    "quantize_x_ms": timer(lambda: quant.quantize_rowwise(x)),
                    "int_mm_ms": timer(lambda: quant._int_mm(xq, wq)),
                    "dequantize_ms": timer(lambda: quant._dequantize(acc, xs, ws, torch.bfloat16)),
                }
            flops = 2.0 * m * k * n
            row["int8_bound_ms"], row["int8_bound_by"] = bound(m * k * 2 + k * n * 4 + m * n * 2,
                                                               flops, INT8_OPS)
            row["bf16_bound_ms"], row["bf16_bound_by"] = bound(m * k * 2 + k * n * 4 + m * n * 2,
                                                               flops, BF16_TENSOR_FLOPS)
            row["int_mm_tops"] = flops / (row["int_mm_ms"] * 1e-3) / 1e12
            rows.append(row)
            del x, layer, dyn, pre, ref, xq, acc
            torch.cuda.empty_cache()
            # a planted fault must fail the exactness or the error gate
            caught = all(not f["int32_exact"] or f["max_rel_err_vs_bf16"] >= INT8_LINEAR_REL_ERR
                         for f in planted.values())
            if not (same and exact and rel < INT8_LINEAR_REL_ERR and caught):
                emit("int8_linear", ok=False, rows=rows)
                raise SystemExit(f"int8 linear wrong on the card (modes same bits, int32 exact, "
                                 f"error under {INT8_LINEAR_REL_ERR}, planted faults caught): {row}")
    cases = _int_mm_exact_cases()
    if not all(c["int32_exact"] for c in cases):
        emit("int8_linear", ok=False, rows=rows, padded_cases=cases)
        raise SystemExit(f"int8 GEMM not exact at a padded shape: {cases}")
    emit("int8_linear", ok=True, rows=rows, padded_cases=cases, rel_err_bound=INT8_LINEAR_REL_ERR,
         bound_rates="int8 1979 TOP/s, bf16 989 TFLOP/s, 3.35 TB/s", card=nvidia_smi_line())


def _int_mm_matches_f64(xq, wq, acc, rows: int = 128) -> bool:
    """``acc`` (the card's int32 ``xq @ wq.T``) against an f64 product of
    the same int8 codes on its first and last ``rows`` rows (all rows when
    fewer): exact, since every partial sum at these K stays below 2^53."""
    import torch

    m = xq.shape[0]
    idx = torch.unique(torch.cat([torch.arange(min(rows, m)), torch.arange(max(m - rows, 0), m)]))
    idx = idx.to(xq.device)
    want = xq[idx].double() @ wq.double().t()
    return bool(torch.equal(acc[idx], want.to(torch.int32)))


def _int_mm_exact_cases() -> list:
    """``quant._int_mm`` at the shapes it pads (M <= 16, K or N not a
    multiple of 8) and one it does not, against the f64 product."""
    import torch

    from memvul_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = []
    for m, k, n in ((1, 768, 2304), (16, 768, 768), (17, 3072, 768), (3, 20, 12), (40, 768, 3072)):
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen, dtype=torch.int8)
        b_t = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int8)
        cases.append({"m": m, "k": k, "n": n,
                      "int32_exact": _int_mm_matches_f64(a, b_t, quant._int_mm(a, b_t), rows=m)})
    return cases


def phase_evaluate_resume(workdir: Path, records: dict, reports: int = 96, crash_after: int = 3) -> None:
    """Restartable scoring on the card: a ``.jsonl`` corpus of ``reports``
    reports of the main path's corpus plus one malformed line and one
    over-long record, scored with ``resume``, ``quarantine``,
    ``attribute_anchors``, ``heartbeat_batches: 1`` and ``score_retries: 1``
    (a) without interruption and (b) with the batch scoring raising once
    after ``crash_after`` batches (the kill, caught here), then resumed.
    The resumed result file must hold the uninterrupted one's bytes, the
    dead-letter file both bad records, and every record its anchor."""
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    src = json.loads((workdir / "test_project.json").read_text())[:reports]
    corpus = workdir / "test_resume.jsonl"
    monster = dict(src[1], Issue_Url=src[1]["Issue_Url"] + "/dump",
                   Issue_Body="core dump follows " * 60_000)
    with open(corpus, "w") as f:
        for i, rec in enumerate(src):
            f.write(json.dumps(rec) + "\n")
            if i == 10:
                f.write("{a torn record\n")
            if i == 20:
                f.write(json.dumps(monster) + "\n")
    # explicit buckets: the auto-bucket sample reads the corpus head without
    # the quarantine (as the reference's does) and would raise on the torn line
    overrides = {"evaluation": {"max_length": 512, "buckets": list(HAND_BUCKETS),
                                "tokens_per_batch": 2048, "aot_warmup": False, "resume": True,
                                "quarantine": True, "attribute_anchors": True,
                                "heartbeat_batches": 1, "score_retries": 1}}
    archive = workdir / "model.tar.gz"
    whole, whole_s, _, launches, _ = _evaluate_counted(archive, corpus, workdir / "resume_whole",
                                                       overrides)
    _check_path_launches("evaluate_resume", whole, launches)
    real, calls = SiamesePredictor._score, {"n": 0, "kill_at": crash_after + 1}

    def counted(self, *args, **kwargs):
        # the batch scoring, counted; it raises once, at call kill_at
        calls["n"] += 1
        if calls["n"] == calls["kill_at"]:
            raise RuntimeError("evaluate_resume: injected kill")
        return real(self, *args, **kwargs)

    SiamesePredictor._score = counted
    try:
        try:
            _evaluate_counted(archive, corpus, workdir / "resume_cut", overrides)
            raise SystemExit("evaluate_resume: the injected kill did not stop the run")
        except RuntimeError as e:
            if "injected kill" not in str(e):
                raise
        result = "model_memory_result.json"
        cut_lines = len((workdir / "resume_cut" / result).read_text().splitlines())
        calls.update(n=0, kill_at=None)
        resumed, resumed_s, _, resumed_launches, _ = _evaluate_counted(
            archive, corpus, workdir / "resume_cut", overrides)
    finally:
        SiamesePredictor._score = real
    a, b = ((workdir / d / result).read_bytes() for d in ("resume_whole", "resume_cut"))
    dead = [json.loads(line)["reason"] for line in
            (workdir / "resume_cut" / (result + ".deadletter")).read_text().splitlines()]
    recs = _result_records(workdir / "resume_cut" / result)
    checks = {
        "byte_identical": a == b,
        "crash_left_a_partial_output": 0 < cut_lines < int(whole["s_batches"]),
        "resume_scored_only_the_rest": calls["n"] == int(whole["s_batches"]) - cut_lines,
        "dead_letters": len(dead) == 2 and "JSONDecodeError" in dead[0] and "over-long" in dead[1],
        "every_record_has_its_anchor": len(recs) == reports and all(
            isinstance(r.get("anchor"), str) and isinstance(r.get("anchor_index"), int)
            and r["predict"][r["anchor"]] == max(r["predict"].values()) for r in recs),
        "metrics_equal": all(resumed[k] == whole[k] for k in ("TP", "FN", "TN", "FP", "f1", "auc")),
    }
    ok = all(checks.values())
    emit("evaluate_resume", ok=ok, checks=checks, reports=reports, batches=whole["s_batches"],
         committed_before_the_kill=cut_lines, resumed_batches=calls["n"],
         quarantined=resumed.get("s_num_quarantined"), dead_letter_reasons=dead,
         whole_wall_s=whole_s, resumed_wall_s=resumed_s, launches=launches,
         resumed_launches=resumed_launches, card=nvidia_smi_line())
    if not ok:
        raise SystemExit(f"evaluate_resume failed: {checks}")
    for run in (launches, resumed_launches):
        records["flash_attention"]["launches"] += run["flash_attention"]
        records["anchor_match"]["launches"] += run["anchor_match"]


def phase_serve_cascade(workdir: Path, records: dict, requests: int = 256, threads: int = 16,
                        split_requests: int = 64) -> None:
    """``serve_from_archive`` with ``score_impl: "cascade"`` on the main
    path's archive: the default band [0.3, 0.7], ``requests`` texts from
    ``threads`` client threads; then ``split_requests`` more through a
    band cut at the int8 tier's median best probability, so both exits
    run.  Every rescored response must hold the bucketed strategy's bits
    for its text at the same shape, every short-circuited one the int8
    tier's answer, within the int8 drift bound of the full-precision one."""
    import threading

    import numpy as np
    import torch

    from memvul_tpu_torch.build import serve_from_archive
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.serving import InprocessClient

    texts_all = corpus_texts(json.loads((workdir / "test_project.json").read_text()))
    runs = {}
    split_cut = None
    for run, n in (("default_band", requests), ("split_band", split_requests)):
        texts = texts_all[:n]
        serving = {"score_impl": "cascade", "default_deadline_ms": 30000}
        if run == "split_band":
            serving.update(cascade_low=0.0, cascade_high=split_cut)
        t0 = time.perf_counter()
        service = serve_from_archive(workdir / "model.tar.gz", device="cuda",
                                     overrides={"serving": serving})
        build_s = time.perf_counter() - t0
        predictor = service.predictor
        torch.cuda.synchronize()
        fa.launches = am.launches = 0
        client = InprocessClient(service)
        results = [None] * len(texts)

        def worker(indices):
            for i in indices:
                results[i] = client.score(texts[i])

        pool = [threading.Thread(target=worker, args=(range(k, len(texts), threads),))
                for k in range(threads)]
        t1 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        traffic_s = time.perf_counter() - t1
        service.drain()
        launches = {"flash_attention": fa.launches, "anchor_match": am.launches}
        snap = service.registry.snapshot()
        counters, hists = snap["counters"], snap["histograms"]
        bad = [r for r in results if r is None or r.get("status") != "ok"]
        if bad:
            raise SystemExit(f"serve_cascade ({run}): {len(bad)} responses not ok, first {bad[0]}")
        labels = predictor.anchor_labels
        got = np.array([[r["predict"][a] for a in labels] for r in results], np.float32)
        fp32 = predictor.score_texts(texts, impl="bucketed")
        int8 = predictor.score_texts(texts, impl="int8")
        low, high = predictor.cascade_band
        in_band = [bool(low <= b <= high) for b in int8.max(axis=1)]
        rescored = [i for i, x in enumerate(in_band) if x]
        short = [i for i, x in enumerate(in_band) if not x]
        checks = {
            "rescored_bitwise_eq_bucketed": all(np.array_equal(got[i], fp32[i]) for i in rescored),
            "shortcircuit_within_drift_of_fp32": all(
                float(np.abs(got[i].max() - fp32[i].max())) < INT8_BEST_PROB_DRIFT for i in short),
            "counters_match_the_band": counters.get("serve.cascade_rescored", 0) == len(rescored)
            and counters.get("serve.cascade_shortcircuit", 0) == len(short),
            "launches": launches["flash_attention"] == 12 * counters["serve.batches"]
            and launches["anchor_match"] == counters["serve.batches"],
        }
        if run == "split_band":
            checks["both_exits_ran"] = bool(rescored) and bool(short)
        latency = hists.get("serve.latency_s", {})
        runs[run] = {
            "ok": all(checks.values()), "checks": checks, "band": [low, high],
            "requests": len(texts), "client_threads": threads, "build_and_warmup_s": build_s,
            "traffic_s": traffic_s, "requests_per_s": len(texts) / traffic_s,
            "latency_p50_ms": latency.get("p50", 0.0) * 1e3,
            "latency_p99_ms": latency.get("p99", 0.0) * 1e3,
            "shortcircuit": counters.get("serve.cascade_shortcircuit", 0),
            "rescored": counters.get("serve.cascade_rescored", 0),
            "device_batches": counters["serve.batches"],
            "shortcircuit_bitwise_eq_int8_offline": all(np.array_equal(got[i], int8[i]) for i in short),
            "shortcircuit_max_abs_diff_vs_fp32": max(
                [float(np.abs(got[i] - fp32[i]).max()) for i in short], default=0.0),
            "launches": launches,
        }
        records["flash_attention"]["launches"] += launches["flash_attention"]
        records["anchor_match"]["launches"] += launches["anchor_match"]
        if split_cut is None:
            # the next run's band: up to the int8 tier's median best probability
            split_cut = float(np.median(predictor.score_texts(
                texts_all[:split_requests], impl="int8").max(axis=1)))
        del service, predictor
        torch.cuda.empty_cache()
        if not runs[run]["ok"]:
            emit("serve_cascade", ok=False, runs=runs, card=nvidia_smi_line())
            raise SystemExit(f"serve_cascade ({run}) failed: {runs[run]['checks']}")
    emit("serve_cascade", ok=True, runs=runs, card=nvidia_smi_line())


# bf16 parity of the packed serve path against the bucketed path on the
# same texts.  The two differ only in how rows reach the card (one
# [1, 2048] pack through the ragged kernel against [16, 512] padded blocks
# through the flash kernel), so every difference is bf16 rounding taken in
# a different order: a few units of 2^-9 in the hidden states over 12
# layers, which moves a probability of this random-weight model by about
# 1e-3.  This bounds the serve path's own error; it cannot see a leak
# across requests or an answer handed to the wrong request, because with
# N(0, 0.02) weights the answers barely depend on the request (their spread
# across requests is printed beside it).  ``kernel_ragged`` and
# ``ragged_reference`` carry the power to see a leak, and ``serve_identity``
# the power to see a swap.
BF16_SERVE_PROBS_ABS = 1e-2


def phase_serve_path(workdir: Path, records: dict, requests: int = 256, threads: int = 16,
                     http_requests: int = 8) -> dict:
    """``serve_from_archive`` on the main path's archive with
    ``score_impl`` "ragged" and then "continuous" (the serving section's
    defaults otherwise: max_length 512, a pack of 2048 tokens and 16 rows):
    ``requests`` texts of the main path's corpus from ``threads`` client
    threads through ``InprocessClient``, then ``http_requests`` through
    ``HTTPClient`` to the front end on 127.0.0.1:0.  The launch counts are
    set to 0 after each service is built and read after its traffic; the
    responses are then held against the bucketed ``score_texts`` of the
    same texts on the card."""
    import threading

    import numpy as np
    import torch

    from memvul_tpu_torch.build import serve_from_archive
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.serving import HTTPClient, InprocessClient
    from memvul_tpu_torch.serving.frontend import run_http_server

    archive = workdir / "model.tar.gz"
    texts = corpus_texts(json.loads((workdir / "test_project.json").read_text()))[:requests]
    layers = 12
    ragged_launches = 0
    runs = {}
    for impl in ("ragged", "continuous"):
        t0 = time.perf_counter()
        service = serve_from_archive(
            archive, device="cuda",
            overrides={"serving": {"score_impl": impl, "default_deadline_ms": 30000}},
        )
        build_s = time.perf_counter() - t0
        predictor = service.predictor
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ra.launches = fa.launches = am.launches = 0
        client = InprocessClient(service)
        results = [None] * len(texts)

        def worker(indices):
            for i in indices:
                results[i] = client.score(texts[i])

        pool = [threading.Thread(target=worker, args=(range(k, len(texts), threads),))
                for k in range(threads)]
        t1 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        traffic_s = time.perf_counter() - t1
        server = run_http_server(service, host="127.0.0.1", port=0)
        try:
            host, port = server.server_address[:2]
            http = HTTPClient(f"http://{host}:{port}")
            over_http = [http.score(texts[i]) for i in range(http_requests)]
            health = http.health()
        finally:
            server.shutdown()
        service.drain()
        launches = {"ragged": ra.launches, "flash": fa.launches, "anchor_match": am.launches}
        peak_bytes = torch.cuda.max_memory_allocated()
        snap = service.registry.snapshot()
        counters, hists = snap["counters"], snap["histograms"]

        bad = [r for r in results + over_http if r is None or r.get("status") != "ok"]
        if bad:
            raise SystemExit(f"serve_path ({impl}): {len(bad)} responses not ok, first {bad[0]}")
        labels = predictor.anchor_labels
        got = np.array([[r["predict"][a] for a in labels] for r in results], np.float64)
        if got.shape != (len(texts), 129) or not np.isfinite(got).all() \
                or got.min() < 0.0 or got.max() > 1.0:
            raise SystemExit(f"serve_path ({impl}): probabilities out of range, shape {got.shape}")
        packs = counters["serve.batches"]
        budget = predictor.token_budget
        checks = {
            "served_eq_requests": counters["serve.served"] == counters["serve.requests"]
            == len(texts) + http_requests,
            "padded_multiple_of_budget": counters["serve.tokens_padded"] % budget == 0,
            "ragged_launches_eq_layers_x_packs": launches["ragged"] == layers * packs,
            "anchor_match_launches_eq_packs": launches["anchor_match"] == packs,
            "health_ok": health.get("status") == "ok" and health.get("score_impl") == impl,
        }
        # the oracle: the same texts through the bucketed blocks on the card
        want = predictor.score_texts(texts, impl="bucketed")
        parity = float(np.abs(got - want).max())
        checks["bucketed_parity"] = parity <= BF16_SERVE_PROBS_ABS
        latency = hists.get("serve.latency_s", {})
        runs[impl] = {
            "ok": all(checks.values()), "checks": checks,
            "requests": len(texts), "client_threads": threads, "http_requests": http_requests,
            "build_and_warmup_s": build_s, "traffic_s": traffic_s,
            "requests_per_s": len(texts) / traffic_s,
            "latency_p50_ms": latency.get("p50", 0.0) * 1e3,
            "latency_p99_ms": latency.get("p99", 0.0) * 1e3,
            "packs": packs, "token_budget": budget, "max_rows_per_pack": predictor.max_rows_per_pack,
            "tokens_real": counters["serve.tokens_real"],
            "tokens_padded": counters["serve.tokens_padded"],
            "token_utilization": counters["serve.tokens_real"] / counters["serve.tokens_padded"],
            "pack_topups": counters.get("serve.pack_topups", 0),
            "truncated": counters.get("serve.truncated", 0),
            "batch_latency_p50_ms": hists.get("serve.batch_latency_s", {}).get("p50", 0.0) * 1e3,
            "launches": launches,
            "bucketed_parity_max_abs": parity, "parity_tol": BF16_SERVE_PROBS_ABS,
            "probs_std_across_requests": float(got.std(axis=0).mean()),
            "peak_memory_gib": peak_bytes / 2**30,
        }
        ragged_launches += launches["ragged"]
        del service, predictor
        torch.cuda.empty_cache()
        if not runs[impl]["ok"]:
            emit("serve_path", ok=False, runs=runs, card=nvidia_smi_line())
            raise SystemExit(f"serve_path ({impl}) failed: {runs[impl]['checks']}")
    emit("serve_path", ok=True, archive="main_path's model.tar.gz", runs=runs, card=nvidia_smi_line())
    records["ragged_flash_attention"]["launches"] = ragged_launches
    # every pack's anchor match has the pack's row count of reports
    anchor = records["anchor_match"]
    rows = int(runs["ragged"]["max_rows_per_pack"])
    served = sum(r["launches"]["anchor_match"] for r in runs.values())
    anchor["launches"] += served
    anchor["launches_by_rows"][rows] = anchor["launches_by_rows"].get(rows, 0) + served
    return runs


# the small f32 model served on the card against its plain bucketed path on
# the CPU, per request and per anchor.  f32 rounding in a different order
# moves a probability by about 1e-7; the phase shows that any two distinct
# requests' answers differ by more than twice this limit, so an answer
# handed to the wrong request cannot pass.
SERVE_IDENTITY_ABS = 1e-6


def _small_archive(workdir: Path) -> Path:
    """An archive of the reference phases' small model (2 layers, 2 heads
    of 64, FFN 256, header 64, 512 positions, f32) beside the main path's
    data in ``workdir``: weights from a seed, the attention weights scaled
    up as in ``_small_model`` so each request's answers differ strongly
    from every other's."""
    from memvul_tpu_torch.archive import save_archive
    from memvul_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    vocab_path = workdir / "vocab.txt"
    vocab_size = len(vocab_path.read_text().splitlines())
    encoder = dict(cfg["model"]["encoder"], hidden_size=128, num_layers=2, num_heads=2,
                   intermediate_size=256, max_position_embeddings=512, dtype="float32",
                   vocab_size=vocab_size)
    model_cfg = dict(cfg["model"], header_dim=64, encoder=encoder)
    params = _random_flax_params(model_cfg, vocab_size, seed=2)
    enc = params["params"]["bert"]["encoder"]
    for layer in ([enc["layers"]["layer"]] if "layers" in enc else enc.values()):
        for name, scale in (("query", 9.0), ("key", 9.0), ("value", 4.0), ("output", 4.0)):
            layer["attention"][name]["kernel"] *= scale
    reader = dict(cfg["dataset_reader"], cve_path=str(workdir / "CVE_dict.json"),
                  anchor_path=str(workdir / "CWE_anchor_golden_project.json"))
    archived = dict(cfg, model=model_cfg, dataset_reader=reader)
    return save_archive(workdir / "small_model.tar.gz", archived, params, tokenizer_file=vocab_path)


def phase_serve_identity(workdir: Path, device: str = "cuda", requests: int = 128,
                         threads: int = 16, burst_texts: int = 4, copies: int = 4) -> None:
    """Which answer goes back to which request, on the continuous path with
    prefix sharing on: the small f32 model's archive served on ``device``
    (``score_impl`` "continuous", ``prefix_share`` on, the serving section's
    defaults otherwise: max_length 512, packs of 2048 tokens and 16 rows).
    ``requests`` distinct texts of the main path's corpus come from
    ``threads`` client threads through ``InprocessClient``, then a burst of
    ``copies`` adjacent copies of each of the ``burst_texts`` shortest texts
    through ``ScoringService.submit``, which alias inside their packs
    (``row_starts`` pointing back, segment ids with gaps).  Every response
    must match the same archive's bucketed path on the CPU to
    ``SERVE_IDENTITY_ABS``, any two distinct requests' answers must differ
    by more than twice that, and the kernels' launch counts must match the
    packs."""
    import threading

    import numpy as np

    from memvul_tpu_torch.build import serve_from_archive
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.serving import InprocessClient

    archive = _small_archive(workdir)
    corpus = corpus_texts(json.loads((workdir / "test_project.json").read_text()))
    texts = list(dict.fromkeys(corpus))[:requests]
    burst = [t for t in sorted(texts, key=len)[:burst_texts] for _ in range(copies)]
    service = serve_from_archive(archive, device=device, overrides={"serving": {
        "score_impl": "continuous", "prefix_share": True, "default_deadline_ms": 30000}})
    ra.launches = am.launches = 0
    client = InprocessClient(service)
    results = [None] * len(texts)

    def worker(indices):
        for i in indices:
            results[i] = client.score(texts[i])

    pool = [threading.Thread(target=worker, args=(range(k, len(texts), threads),))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    futures = [service.submit(t) for t in burst]
    results += [f.result(60) for f in futures]
    service.drain()
    launches = {"ragged": ra.launches, "anchor_match": am.launches}
    counters = service.registry.snapshot()["counters"]
    labels = service.predictor.anchor_labels
    layers = service.predictor.model.config.num_layers
    del service

    reference = serve_from_archive(archive, device="cpu",
                                   overrides={"serving": {"default_deadline_ms": 30000}})
    sent = texts + burst
    want = reference.predictor.score_texts(sent, impl="bucketed")
    seqs = reference.predictor.encoder.encode_many(sent)
    reference.drain()
    bad = [r for r in results if r is None or r.get("status") != "ok"]
    if bad:
        raise SystemExit(f"serve_identity: {len(bad)} responses not ok, first {bad[0]}")
    got = np.array([[r["predict"][a] for a in labels] for r in results], np.float64)
    err = float(np.abs(got - want).max())
    # the closest two requests whose token rows differ
    apart = np.abs(want[:, None, :] - want[None, :, :]).max(axis=-1)
    same = np.array([[a == b for b in seqs] for a in seqs])
    margin = float(apart[~same].min())
    packs = counters["serve.batches"]
    checks = {
        "served_eq_requests": counters["serve.served"] == counters["serve.requests"] == len(sent),
        "per_request_within_tol": err <= SERVE_IDENTITY_ABS,
        "distinct_requests_apart": margin > 2 * SERVE_IDENTITY_ABS,
        "rows_aliased": counters.get("serve.prefix_rows_aliased", 0) > 0,
        "ragged_launches_eq_layers_x_packs": launches["ragged"] == layers * packs,
        "anchor_match_launches_eq_packs": launches["anchor_match"] == packs,
    }
    ok = all(checks.values())
    emit("serve_identity", ok=ok, checks=checks, requests=len(texts), client_threads=threads,
         burst=len(burst), max_abs_err=err, tol=SERVE_IDENTITY_ABS,
         closest_distinct_requests=margin, packs=packs,
         rows_aliased=counters.get("serve.prefix_rows_aliased", 0),
         tokens_saved=counters.get("serve.prefix_tokens_saved", 0), launches=launches)
    if not ok:
        raise SystemExit(f"serve_identity failed: {checks}")


def _kernel_breakdown(fn, attempts: int = 3):
    """Device time by kernel group of one call of ``fn``, by torch.profiler:
    (ms per group, the eight costliest kernels).  A profile that caught no
    device activity at all (CUPTI now and then hands back none) is taken
    again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0)]
        if events:
            break
    by_name: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        # a user annotation (the optimizer's step, an autograd Function)
        # spans kernels already counted
        if not us or getattr(evt, "is_user_annotation", False) or evt.key.startswith(
                ("aten::", "cuda", "Memcpy", "Memset", "ProfilerStep")):
            continue
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    groups: dict = {}
    for name, ms in by_name.items():
        low = name.lower()
        group = ("flash_fwd" if "flash_fwd" in low else
                 "ragged_fwd" if "ragged_fwd" in low or "tile_ranges" in low else
                 "anchor_match" if "anchor_match" in low else
                 "gemm" if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "sm90")) else
                 "layer_norm" if "layer_norm" in low else
                 "gelu" if "gelu" in low else "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return groups, [[name[:80], ms] for name, ms in top]


def phase_profile(archive: Path, rows: int = 128, length: int = 2048) -> None:
    """Where the time goes, through the archived full-width model: device
    time by kernel (torch.profiler) for one scoring batch of the main
    path's 2048 bucket (128 rows; CUDA events give its device span), and
    for one round trip of a serve pack (the fullest realistic pack of 2048
    tokens, 16 rows: its host copy in, the encoder, the anchor match and
    the copy out, as ``score_ragged_sample`` runs it), beside that round
    trip's host wall time, which gives the card's busy share."""
    import numpy as np
    import torch

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.data.batching import collate_ragged
    from memvul_tpu_torch.models.memory import anchor_probs

    arch = load_archive(archive, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(5, 300, (rows, length), device="cuda", generator=gen)
    mask = torch.ones_like(ids)
    bank = torch.randn(129, 512, device="cuda", generator=gen).to(torch.bfloat16)

    def batch():
        with torch.no_grad():
            return anchor_probs(arch.model({"input_ids": ids, "attention_mask": mask}, anchors=bank))

    batch_ms = time_ms(batch, 3)
    groups, top = _kernel_breakdown(batch)
    total = sum(groups.values())
    emit("main_path_profile", shape=[rows, length], batch_ms=batch_ms,
         kernel_ms=groups, kernel_share={k: v / total for k, v in groups.items()} if total else {},
         device_busy_share=total / batch_ms if batch_ms else None, top_kernels=top)

    _, lens = _realistic_pack(2048, 512)
    rng = np.random.default_rng(3)
    sample = collate_ragged([list(rng.integers(5, 300, size=n)) for n in lens], 2048, 16, pad_id=0)

    def pack():
        dev = {k: torch.from_numpy(v).to("cuda").long() for k, v in sample.items()}
        with torch.no_grad():
            return anchor_probs(arch.model.score_ragged(dev, bank)).cpu()

    pack()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        pack()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    groups, top = _kernel_breakdown(pack)
    total = sum(groups.values())
    emit("serve_pack_profile", rows=len(lens), tokens=sum(lens), token_budget=2048,
         wall_ms=wall_ms, kernel_ms=groups, kernel_total_ms=total,
         device_busy_share=total / wall_ms, top_kernels=top)
    del arch


def _train_config(ws: dict, **trainer) -> dict:
    """``config_memory_longctx.json`` pointed at a ``build_workspace``
    workspace, with bert-base's 30522-row embedding (as ``main_path``) and
    ``trainer`` overrides."""
    from memvul_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    paths = ws["paths"]
    cfg["tokenizer"] = {"type": "wordpiece", "tokenizer_path": paths["tokenizer"]}
    cfg["dataset_reader"] = dict(cfg["dataset_reader"], cve_path=paths["cve"],
                                 anchor_path=paths["anchors"])
    cfg["train_data_path"], cfg["validation_data_path"] = paths["train"], paths["validation"]
    cfg["model"] = dict(cfg["model"], encoder=dict(cfg["model"]["encoder"], vocab_size=30522))
    cfg["trainer"] = dict(cfg["trainer"], **trainer)
    return cfg


class _LaunchRecorder:
    """Counts K2 launches by [rows, length] while installed, by wrapping
    the kernel's launcher (instrumentation of this script only), and K1/K2
    launches around the trainer's ``validate`` (``MemoryTrainer``'s unless
    ``trainer_cls`` names another)."""

    def __init__(self, trainer_cls=None):
        from memvul_tpu_torch.ops import anchor_match as am
        from memvul_tpu_torch.ops import flash_attention as fa
        from memvul_tpu_torch.training.trainer import MemoryTrainer

        self.fa, self.am, self.trainer_cls = fa, am, trainer_cls or MemoryTrainer
        self.by_shape: dict = {}
        self.validation = {"flash": 0, "anchor_match": 0, "seconds": 0.0}

    def __enter__(self):
        fa, am, rec = self.fa, self.am, self
        self._launch, self._validate = fa.flash_attention_cuda, self.trainer_cls.validate

        def launch(q, *args):
            key = (int(q.shape[0]), int(q.shape[1]))
            rec.by_shape[key] = rec.by_shape.get(key, 0) + 1
            return rec._launch(q, *args)

        def validate(trainer):
            import torch

            f0, a0, t0 = fa.launches, am.launches, time.perf_counter()
            out = rec._validate(trainer)
            torch.cuda.synchronize()
            rec.validation["flash"] += fa.launches - f0
            rec.validation["anchor_match"] += am.launches - a0
            rec.validation["seconds"] += time.perf_counter() - t0
            return out

        fa.flash_attention_cuda, self.trainer_cls.validate = launch, validate
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda, self.trainer_cls.validate = self._launch, self._validate


def phase_train_path(workdir: Path, records: dict, steps: int = 8) -> None:
    """Training at the full width of ``config_memory_longctx.json``
    (BERT-base, bf16, flash, batch 32, grad_accum 2, max_length 256, pow2
    buckets, dedup, the shipped param groups and clip) through
    ``train_from_config`` on a port-built ``build_workspace`` corpus: one
    epoch of ``steps`` optimizer steps (warmup cut to 2 steps so the lr is
    not 0), validation at the config's eval buckets, the archive, and
    ``evaluate_from_archive`` of that archive on the card.  Cut to size:
    steps and corpus size.  ``sync_every`` 1 so each step's time is its
    own.  The counts of K1 and K2 are set to 0 before and read after, with
    validation's share read around it.  A second, 2-step run with encoder
    ``attention_dropout`` 0 (and no validation) must launch K2 12 layers ×
    2 towers × microbatches times in its train steps."""
    import numpy as np
    import torch

    from memvul_tpu_torch.build import evaluate_from_archive, train_from_config
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    ws = build_workspace(workdir / "train_ws", seed=0, num_projects=16, reports_per_project=32,
                         realistic_lengths=True)
    cfg = _train_config(ws, num_epochs=1, steps_per_epoch=steps, warmup_steps=2, sync_every=1)
    setup_s = time.perf_counter() - t0
    layers = 12

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = am.launches = 0
    t1 = time.perf_counter()
    with _LaunchRecorder() as rec:
        result = train_from_config(cfg, workdir / "train_run", device="cuda")
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t1
    flash_total, match_total = fa.launches, am.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    epoch = result["history"][0]
    losses = epoch["training_losses"]
    steps_s = epoch["training_step_durations_s"]
    after_first = steps_s[1:]

    # the archive, scored by the evaluation entry point on the card
    t2 = time.perf_counter()
    metrics = evaluate_from_archive(result["archive"], ws["paths"]["test"], workdir / "train_eval",
                                    overrides={"evaluation": cfg["evaluation"]}, device="cuda")
    eval_s = time.perf_counter() - t2
    recs = [r for line in (workdir / "train_eval" / "model_memory_result.json").read_text()
            .splitlines() if line.strip() for r in json.loads(line)]
    probs = np.array([list(r["predict"].values()) for r in recs], np.float64)
    test_reports = len(ws["splits"]["test"])
    shutil.rmtree(workdir / "train_run")  # checkpoints of 1.3 GB each, no longer needed

    checks = {
        "steps": len(losses) == steps,
        "losses_finite": bool(np.isfinite(losses).all()),
        "validation_ran": "validation_s_f1-score" in epoch,
        "validation_launched_k1": rec.validation["anchor_match"] > 0,
        "validation_launched_k2": rec.validation["flash"] > 0,
        # attention dropout 0.1 trains through the "xla" formulation
        "train_steps_k2_launches_zero_with_attention_dropout": flash_total == rec.validation["flash"],
        "archive_scored": len(recs) == test_reports and probs.shape[1] == len(ws["anchors"])
        and bool(np.isfinite(probs).all()) and probs.min() >= 0.0 and probs.max() <= 1.0,
    }

    # dropout 0: K2 forward in every train step through the autograd Function
    cfg0 = _train_config(ws, num_epochs=1, steps_per_epoch=2, warmup_steps=2, sync_every=1)
    cfg0["validation_data_path"] = None
    cfg0["model"]["encoder"]["attention_dropout"] = 0.0
    fa.launches = 0
    with _LaunchRecorder() as rec0:
        result0 = train_from_config(cfg0, workdir / "train_run_dropout0", device="cuda")
    torch.cuda.synchronize()
    microbatches = 2 * int(cfg0["trainer"]["grad_accum"])
    flash0 = fa.launches
    checks["dropout0_k2_launches_eq_layers_x_towers_x_microbatches"] = (
        flash0 == layers * 2 * microbatches)
    checks["dropout0_losses_finite"] = bool(np.isfinite(result0["history"][0]["training_losses"]).all())

    checks = {k: bool(v) for k, v in checks.items()}
    checks = {k: bool(v) for k, v in checks.items()}
    line = {
        "ok": all(checks.values()), "checks": checks, "config": str(CONFIG.relative_to(ROOT)),
        "reduced": {"steps": steps, "epochs": 1, "warmup_steps": 2,
                    "train_reports": len(ws["splits"]["train"]),
                    "validation_reports": len(ws["splits"]["validation"]),
                    "anchors": len(ws["anchors"])},
        "setup_s": setup_s, "train_from_config_wall_s": train_wall_s,
        "step_s_first": steps_s[0], "step_s_median": float(np.median(after_first)),
        "step_s_max": float(np.max(after_first)),
        "padded_tokens": epoch["training_padded_tokens"], "real_tokens": epoch["training_real_tokens"],
        "padded_tokens_per_s": epoch["training_padded_tokens"] / float(np.sum(steps_s)),
        "real_tokens_per_s": epoch["training_real_tokens"] / float(np.sum(steps_s)),
        "epoch_seconds": epoch["training_epoch_seconds"],
        "peak_memory_gib": peak_bytes / 2**30,
        "validation_s": rec.validation["seconds"],
        "validation_launches": {"flash": rec.validation["flash"],
                                "anchor_match": rec.validation["anchor_match"]},
        "validation_f1": epoch["validation_s_f1-score"], "validation_auc": epoch["validation_s_auc"],
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "grad_norms": epoch["training_grad_norms"],
        "evaluate_archive_s": eval_s, "archive_test_reports": len(recs),
        "archive_s_auc": metrics.get("s_auc"),
        "dropout0": {"steps": 2, "microbatches": microbatches, "k2_launches": flash0,
                     "want": layers * 2 * microbatches,
                     "k2_launches_by_shape": {f"{b}x{t}": n for (b, t), n in
                                              sorted(rec0.by_shape.items())}},
        "card": nvidia_smi_line(),
    }
    emit("train_path", **line)
    if not line["ok"]:
        raise SystemExit(f"train_path failed: {checks}")
    # K2 at the train step's shapes beside its launches per optimizer step
    fl = records["flash_attention"]
    per_step = {shape: n / 2 for shape, n in rec0.by_shape.items()}
    rows = []
    for shape, n in sorted(per_step.items()):
        timed = fl["shapes"].get(shape)
        row = {"shape": [*shape, 12, 64], "launches_per_step": n}
        if timed is not None:
            row.update({k: timed.get(k) for k in ("kernel_name", "kernel_ms", "kernel_device_ms",
                                                  "library_ms", "library_device_ms", "plain_ms",
                                                  "bound_ms", "bound_by")})
        rows.append(row)
    emit("kernel_flash_train_shapes", rows=rows, steps=2, card=nvidia_smi_line())
    fl["launches"] += flash_total + flash0
    records["anchor_match"]["launches"] += match_total
    _train_step_profile(cfg)


def _train_step_profile(cfg: dict, stacks: int = 3) -> None:
    """Host wall against device time of single train steps of
    ``train_path``'s configuration (as shipped: attention dropout 0.1), by
    torch.profiler: the trainer's own stacks, the first one warming up,
    each later one timed from the call to a synchronize, then profiled."""
    import torch

    from memvul_tpu_torch.build import build_model, build_reader, build_tokenizer, init_params
    from memvul_tpu_torch.training.trainer import MemoryTrainer, TrainerConfig, train_step

    tok = build_tokenizer(cfg["tokenizer"])
    model = init_params(build_model(cfg["model"], tok.vocab_size), 0)
    trainer = MemoryTrainer(model, tok, build_reader(cfg["dataset_reader"], seed=0),
                            cfg["train_data_path"], config=TrainerConfig(**cfg["trainer"]),
                            device="cuda")
    trainer.model.train()
    feed = trainer._microbatch_stacks()

    def step(stack):
        return train_step(trainer.model, trainer.optimizer, stack, trainer.generator)

    step(trainer._commit_stack(next(feed))[0])
    rows = []
    for _ in range(stacks):
        stack, info = trainer._commit_stack(next(feed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(stack)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        groups, top = _kernel_breakdown(lambda: step(stack))
        kernel_ms = sum(groups.values())
        rows.append({"sample1": list(stack["sample1"]["input_ids"].shape),
                     "sample2": list(stack["sample2"]["input_ids"].shape), **info,
                     "wall_ms": wall_ms, "kernel_ms": kernel_ms,
                     "device_busy_share": kernel_ms / wall_ms, "kernel_ms_by_group": groups,
                     "top_kernels": top[:5]})
    emit("train_step_profile", steps=rows, card=nvidia_smi_line())
    del trainer, model


# -- the paper's other training paths ----------------------------------------


def _other_workspace(workdir: Path) -> dict:
    """The ``build_workspace`` corpus of the pretrain, single and TextCNN
    phases: 1024 reports of realistic lengths in 32 projects (the splits'
    train part holds enough single-text batches for ``single_path``'s
    steps in one epoch)."""
    from memvul_tpu_torch.data.synthetic import build_workspace

    return build_workspace(workdir / "other_ws", seed=1, num_projects=32, reports_per_project=32,
                           realistic_lengths=True)


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def _step_fields(durations: list, padded: int, real: int) -> dict:
    import numpy as np

    rest = durations[1:] or durations
    return {"step_s_first": durations[0], "step_s_median": float(np.median(rest)),
            "step_s_max": float(np.max(rest)), "padded_tokens": padded, "real_tokens": real,
            "padded_tokens_per_s": padded / float(np.sum(durations)),
            "real_tokens_per_s": real / float(np.sum(durations))}


def phase_pretrain_path(workdir: Path, ws: dict, records: dict, updates: int = 8) -> None:
    """MLM further pretraining through ``build.pretrain_from_config`` with
    ``configs/further_pretrain.json`` at its widths (BERT-base, bf16, batch
    16 × grad_accum 2 × 256, mask 0.15) on a ``build_workspace`` text
    corpus, its encoder given bert-base's 30522-row table and stacked
    layers (``scan_layers``, as the memory configs have it): ``updates``
    updates (warmup cut to 2, so the weights move; ``sync_every`` 1), then
    the held-out ``evaluate``.  The encoder it writes (``encoder.msgpack``)
    then starts 2 train steps of ``config_memory_longctx.json`` (dropout as
    shipped; positions cut to the pretrained encoder's 512), whose encoder
    must equal the saved tensors bit for bit before the first step; the
    same checkpoint loaded into an unstacked (``scan_layers`` false) model
    must be refused.  A second run of 2 updates at attention dropout 0
    with ``attention_impl`` "flash" must launch K2 12 layers × grad_accum
    times an update (its forward under autograd)."""
    import copy

    import numpy as np
    import torch

    from memvul_tpu_torch import _msgpack, build
    from memvul_tpu_torch.config import load_config
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.models.convert import encoder_from_flax
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.training.trainer import MemoryTrainer

    splits = ws["splits"]
    corpus, held_out = workdir / "mlm_train.txt", workdir / "mlm_validation.txt"
    corpus.write_text("\n".join(corpus_texts(splits["train"] + splits["test"])) + "\n")
    held_out.write_text("\n".join(corpus_texts(splits["validation"])) + "\n")
    cfg = load_config(ROOT / "configs" / "further_pretrain.json")
    cfg["tokenizer"] = {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]}
    cfg["encoder"] = dict(cfg["encoder"], vocab_size=30522, scan_layers=True)
    cfg.update(train_data_path=str(corpus), validation_data_path=str(held_out),
               output_dir=str(workdir / "out_wwm"))
    cfg["trainer"] = dict(cfg["trainer"], num_epochs=1, steps_per_epoch=updates, warmup_steps=2,
                          sync_every=1)
    layers, accum = 12, int(cfg["trainer"]["grad_accum"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    report = build.pretrain_from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = _peak_gib()
    launches_shipped = fa.launches  # attention dropout 0.1 and "xla" attention: none
    epoch = report["train"]["epochs"][0]
    losses = epoch["losses"]

    # the encoder carried into the memory model's training
    mem = _train_config(ws, num_epochs=1, steps_per_epoch=2, warmup_steps=2, sync_every=1)
    mem["validation_data_path"] = None
    mem["model"]["encoder"] = dict(mem["model"]["encoder"], max_position_embeddings=512)
    mem["model"]["pretrained_checkpoint"] = str(workdir / "out_wwm")
    bert_cfg = build.encoder_config(mem["model"]["encoder"])
    saved = encoder_from_flax(_msgpack.unpackb(Path(report["checkpoint"]).read_bytes()), bert_cfg)
    seen: dict = {}
    original = MemoryTrainer.train

    def train(trainer):
        live = trainer.model.bert.state_dict()
        seen["keys"] = sorted(live) == sorted(saved)
        seen["bit_equal"] = seen["keys"] and all(torch.equal(v.cpu(), saved[k]) for k, v in live.items())
        return original(trainer)

    MemoryTrainer.train = train
    try:
        t1 = time.perf_counter()
        transplant = build.train_from_config(mem, workdir / "transplant_run", device="cuda")
        transplant_s = time.perf_counter() - t1
    finally:
        MemoryTrainer.train = original
    shutil.rmtree(workdir / "transplant_run")
    unstacked = build.build_model(dict(mem["model"], encoder=dict(mem["model"]["encoder"],
                                                                  scan_layers=False)), 30522)
    try:
        build.load_pretrained_encoder(unstacked, workdir / "out_wwm")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    del unstacked

    # attention dropout 0 through the flash kernel: K2 under autograd
    cfg0 = copy.deepcopy(cfg)
    cfg0["encoder"] = dict(cfg["encoder"], attention_dropout=0.0, attention_impl="flash")
    cfg0.update(validation_data_path=None, output_dir=str(workdir / "out_wwm_flash"))
    cfg0["trainer"] = dict(cfg["trainer"], steps_per_epoch=2)
    fa.launches = 0
    with _LaunchRecorder() as rec0:
        report0 = build.pretrain_from_config(cfg0, device="cuda")
    torch.cuda.synchronize()
    flash0 = fa.launches
    want0 = layers * accum * 2

    checks = {
        "updates": len(losses) == updates,
        "losses_finite": bool(np.isfinite(losses).all()),
        "eval_finite": bool(np.isfinite(report["eval_loss"])) and report["perplexity"] > 1.0,
        "shipped_attention_launches_no_k2": launches_shipped == 0,
        "transplant_bit_equal_before_first_step": bool(seen.get("bit_equal")),
        "transplant_trained": len(transplant["history"][0]["training_losses"]) == 2
        and bool(np.isfinite(transplant["history"][0]["training_losses"]).all()),
        "layout_refused": refusal is not None and "scan_layers" in refusal,
        "dropout0_k2_launches_eq_layers_x_accum_x_updates": flash0 == want0,
        "dropout0_losses_finite": bool(np.isfinite(report0["train"]["epochs"][0]["losses"]).all()),
    }
    timed = records["flash_attention"]["shapes"].get((16, 256), {})
    checks = {k: bool(v) for k, v in checks.items()}
    line = {
        "ok": all(checks.values()), "checks": checks,
        "config": "configs/further_pretrain.json (+ vocab_size 30522, scan_layers true)",
        "reduced": {"updates": updates, "epochs": 1, "warmup_steps": 2,
                    "corpus_lines": len(splits["train"]) + len(splits["test"]),
                    "held_out_lines": len(splits["validation"])},
        "wall_s": wall, **_step_fields(epoch["step_durations_s"], epoch["padded_tokens"],
                                       epoch["real_tokens"]),
        "peak_memory_gib": peak, "eval_s": report["train"]["eval_s"],
        "eval_loss": report["eval_loss"], "perplexity": report["perplexity"],
        "eval_masked_tokens": report["masked_tokens"], "first_loss": losses[0],
        "last_loss": losses[-1], "losses": losses,
        "transplant": {"config": "configs/config_memory_longctx.json (positions 512)",
                       "train_from_config_s": transplant_s,
                       "losses": transplant["history"][0]["training_losses"],
                       "layout_refusal": refusal},
        "dropout0": {"updates": 2, "k2_launches": flash0, "want": want0,
                     "k2_launches_by_shape": {f"{b}x{t}": n for (b, t), n in
                                              sorted(rec0.by_shape.items())},
                     "step_durations_s": report0["train"]["epochs"][0]["step_durations_s"],
                     "k2_at_16x256": {k: timed.get(k) for k in (
                         "kernel_ms", "kernel_device_ms", "library_ms", "library_device_ms",
                         "plain_ms", "bound_ms", "bound_by")}},
        "card": nvidia_smi_line(),
    }
    emit("pretrain_path", **line)
    if not line["ok"]:
        raise SystemExit(f"pretrain_path failed: {checks}")
    records["flash_attention"]["launches"] += launches_shipped + flash0


def phase_pretrain_reference(updates: int = 4) -> None:
    """A small f32 MLM (``BertConfig.tiny``'s width: 64 wide, 4 heads of
    16, 2 layers; dropout 0; flash attention) trained ``updates`` updates
    by ``mlm_train_step`` on the card (K2 under autograd) and on the CPU
    (plain versions), from the same weights on the same masked stacks (2
    microbatches of 4 rows × 64, random ids and lengths from a seed, the
    last stack's second microbatch empty): losses and the weights' total
    update must agree to ``train_reference``'s f32 limits (TF32 off)."""
    import copy

    import numpy as np
    import torch

    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.pretrain.mlm import IGNORE, MLMModel, mlm_train_step
    from memvul_tpu_torch.training.optim import make_optimizer

    rng = np.random.default_rng(9)
    stacks = []
    for n in range(updates):
        ids = rng.integers(5, 500, size=(2, 4, 64))
        mask = np.zeros_like(ids)
        for k in range(2):
            for i, length in enumerate(rng.integers(2, 65, size=4)):
                mask[k, i, :length] = 1
        if n == updates - 1:
            mask[1] = 0  # an epoch tail's empty microbatch
        labels = np.where((rng.random(ids.shape) < 0.15) & (mask > 0), ids, IGNORE)
        labels[0, :, 1] = ids[0, :, 1]  # every stack's first microbatch holds a masked token
        stacks.append((ids, mask, labels))
    cfg = BertConfig.tiny(vocab_size=500, attention_impl="flash", hidden_dropout=0.0,
                          attention_dropout=0.0)
    torch.manual_seed(0)
    base = MLMModel(cfg)
    runs = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device).train()
        opt = make_optimizer(model.named_parameters(), group_lrs={}, group_rules=(), base_lr=1e-3,
                             grad_clip_norm=1.0, weight_decay=0.0,
                             lr_schedule={"type": "linear_with_warmup", "warmup_steps": 1})
        launches0 = fa.launches
        losses = [float(mlm_train_step(model, opt, *(torch.from_numpy(x).long().to(device)
                                                     for x in st))) for st in stacks]
        runs[device] = {"losses": losses, "launches": fa.launches - launches0,
                        "params": {k: v.detach().float().cpu() for k, v in model.state_dict().items()}}
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"]))
    start = {k: v.float() for k, v in base.state_dict().items()}
    diff = torch.cat([(runs["cuda"]["params"][k] - runs["cpu"]["params"][k]).flatten() for k in start])
    moved = torch.cat([(runs["cpu"]["params"][k] - start[k]).flatten() for k in start])
    update_rel = float(diff.norm() / moved.norm())
    want_launches = cfg.num_layers * 2 * updates
    limits = TRAIN_REF_F32
    ok = (loss_err <= limits["loss_abs"] and update_rel <= limits["update_rel"]
          and runs["cuda"]["launches"] == want_launches
          and bool(np.isfinite(runs["cuda"]["losses"]).all()))
    emit("pretrain_reference", ok=ok, updates=updates, cuda_losses=runs["cuda"]["losses"],
         cpu_losses=runs["cpu"]["losses"], loss_max_abs_err=loss_err, update_rel_err=update_rel,
         param_max_abs_err=float(diff.abs().max()), param_max_abs_move=float(moved.abs().max()),
         k2_launches=runs["cuda"]["launches"], want_launches=want_launches, limits=limits)
    if not ok:
        raise SystemExit("card and CPU MLM training disagree")


def _classifier_config(name: str, ws: dict, steps: int, **tokenizer) -> dict:
    """A shipped single-model config pointed at the workspace: every
    negative kept (``sample_neg`` 1.0, shipped 0.05, so ``steps`` batches
    fit one epoch), one epoch of ``steps`` steps, ``sync_every`` 1."""
    from memvul_tpu_torch.config import load_config

    cfg = load_config(ROOT / "configs" / name)
    cfg["tokenizer"] = tokenizer
    cfg["train_data_path"], cfg["validation_data_path"] = ws["paths"]["train"], ws["paths"]["validation"]
    cfg["dataset_reader"] = dict(cfg["dataset_reader"], sample_neg=1.0)
    cfg["trainer"] = dict(cfg["trainer"], num_epochs=1, steps_per_epoch=steps, sync_every=1)
    return cfg


def _train_classifier(cfg: dict, run: Path):
    """``train_from_config`` on the card with K2 counted: (result, wall s,
    peak GiB, K2 launches of the run, of its validation, validation s)."""
    import torch

    from memvul_tpu_torch.build import train_from_config
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.training.single_trainer import ClassifierTrainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    with _LaunchRecorder(ClassifierTrainer) as rec:
        result = train_from_config(cfg, run, device="cuda")
    torch.cuda.synchronize()
    return (result, time.perf_counter() - t0, _peak_gib(), fa.launches, rec.validation["flash"],
            rec.validation["seconds"])


def _single_scoring(metrics: dict, recs: list, wall: float, peak: float) -> dict:
    slots = sum(int(n) * int(length) for length, n in metrics["bucket_row_slots"].items())
    return {"reports": len(recs), "reports_per_s": len(recs) / metrics["elapsed_s"],
            "scoring_s": metrics["elapsed_s"], "warmup_s": metrics.get("warmup_s"), "wall_s": wall,
            "stream_shapes": [list(x) for x in metrics["stream_shapes"]],
            "bucket_batches": metrics["bucket_batches"], "live_padded_tokens": metrics["padded_tokens"],
            "real_tokens": metrics["real_tokens"], "slot_tokens": slots, "peak_memory_gib": peak,
            "f1": metrics["f1"], "auc": metrics["auc"]}


def phase_single_path(workdir: Path, ws: dict, records: dict, steps: int = 8) -> None:
    """MemVul-m at full width: ``configs/config_single.json`` (BERT-base,
    bf16, batch 64, length 256, the shipped groups and clip) with
    ``attention_impl`` "flash", bert-base's 30522-row table and no
    pretrained checkpoint, trained ``steps`` steps (warmup cut to 2) with
    validation, archived; then 512 reports (the main path's corpus) scored
    with ``configs/test_config_single.json`` verbatim (auto-8 buckets,
    262144 tokens a batch, warmup): K2 launched 12 times a forward, held
    against its plain version at every auto shape; and the same archive
    scored again through the "xla" attention, which must agree (probability
    within bf16's 3e-2, the prediction wherever the probability is not
    within 3e-2 of 0.5)."""
    import numpy as np

    from memvul_tpu_torch.config import loads_config, merge_overrides

    cfg = _classifier_config("config_single.json", ws, steps, type="wordpiece",
                             tokenizer_path=ws["paths"]["tokenizer"])
    cfg["model"] = dict(cfg["model"], encoder=dict(cfg["model"]["encoder"], vocab_size=30522,
                                                   attention_impl="flash"))
    cfg["model"].pop("pretrained_checkpoint")
    cfg["trainer"]["warmup_steps"] = 2
    result, train_wall, train_peak, train_k2, val_k2, val_s = _train_classifier(
        cfg, workdir / "single_run")
    epoch = result["history"][0]
    archive = workdir / "single_archive.tar.gz"
    shutil.move(result["archive"], archive)
    shutil.rmtree(workdir / "single_run")

    test_path = workdir / "test_project.json"
    text = (ROOT / "configs" / "test_config_single.json").read_text()
    metrics, wall, peak, launches, _ = _evaluate_counted(archive, test_path, workdir / "single_eval",
                                                         text)
    recs = _result_records(workdir / "single_eval" / "model_single_result.json")
    shapes = [list(x) for x in metrics["stream_shapes"]]
    want_k2 = 12 * (len(shapes) + int(metrics["batches"]))  # warmup: each shape once
    xla, xla_wall, _, xla_launches, _ = _evaluate_counted(
        archive, test_path, workdir / "single_eval_xla",
        merge_overrides(loads_config(text), {"model": {"encoder": {"attention_impl": "xla"}}}))
    xrecs = {r["Issue_Url"]: r for r in _result_records(
        workdir / "single_eval_xla" / "model_single_result.json")}
    prob_err = max(abs(r["prob"] - xrecs[r["Issue_Url"]]["prob"]) for r in recs)
    decided = [r for r in recs if abs(r["prob"] - 0.5) > 3e-2]
    flips = sum(r["predict"] != xrecs[r["Issue_Url"]]["predict"] for r in decided)
    flash = _flash_at_auto_shapes(shapes, records)
    probs = np.array([r["prob"] for r in recs])
    checks = {
        "steps": len(epoch["training_losses"]) == steps,
        "losses_finite": bool(np.isfinite(epoch["training_losses"]).all()),
        "validation_ran": "validation_pos_f1-score" in epoch and val_k2 > 0,
        "train_steps_k2_launches_zero_with_attention_dropout": train_k2 == val_k2,
        "records": len(recs) == 512 and set(xrecs) == {r["Issue_Url"] for r in recs}
        and bool(np.isfinite(probs).all()) and probs.min() >= 0.0 and probs.max() <= 1.0,
        "k2_launches_12_a_forward": launches["flash_attention"] == want_k2
        and launches["anchor_match"] == 0,
        "xla_launches_no_k2": xla_launches["flash_attention"] == 0,
        "flash_vs_xla_prob_within_3e-2": prob_err <= 3e-2,
        "flash_vs_xla_decisions_agree": flips == 0,
    }
    checks = {k: bool(v) for k, v in checks.items()}
    line = {
        "ok": all(checks.values()), "checks": checks,
        "config": "configs/config_single.json (+ attention_impl flash, vocab_size 30522, "
                  "no pretrained_checkpoint); configs/test_config_single.json (verbatim)",
        "reduced": {"steps": steps, "epochs": 1, "warmup_steps": 2, "sample_neg": 1.0,
                    "train_reports": len(ws["splits"]["train"]),
                    "validation_reports": len(ws["splits"]["validation"])},
        "train_from_config_wall_s": train_wall,
        **_step_fields(epoch["training_step_durations_s"], epoch["training_padded_tokens"],
                       epoch["training_real_tokens"]),
        "train_peak_memory_gib": train_peak, "validation_s": val_s, "validation_k2_launches": val_k2,
        "validation_f1": epoch["validation_pos_f1-score"], "losses": epoch["training_losses"],
        "scoring": _single_scoring(metrics, recs, wall, peak),
        "k2_launches": launches["flash_attention"], "k2_launches_want": want_k2,
        "xla_scoring": {"reports_per_s": len(recs) / xla["elapsed_s"], "scoring_s": xla["elapsed_s"],
                        "wall_s": xla_wall},
        "flash_vs_xla": {"prob_max_abs_err": prob_err, "decided": len(decided), "flips": flips},
        "card": nvidia_smi_line(),
    }
    emit("single_path", **line)
    emit("kernel_flash_single_shapes", ok=True, cases=flash, tol=3e-2, card=nvidia_smi_line())
    if not line["ok"]:
        raise SystemExit(f"single_path failed: {checks}")
    records["flash_attention"]["launches"] += train_k2 + launches["flash_attention"]


def phase_cnn_path(workdir: Path, ws: dict, records: dict, steps: int = 8) -> None:
    """TextCNN at ``configs/config_cnn.json``'s widths (300-d embedding,
    256 filters at n-grams 2-5, header 512, batch 64, length 256, Adam at
    1e-3): a ``WordTokenizer`` vocabulary built from the workspace's train
    split, ``steps`` steps with validation, the archive; then the main
    path's 512 reports scored with ``configs/test_config_cnn.json``
    verbatim (batch 64, padded to 512)."""
    import numpy as np

    from memvul_tpu_torch.data.readers import SingleReader
    from memvul_tpu_torch.data.tokenizer import WordTokenizer

    vocab_path = workdir / "word_vocab.json"
    texts = [inst["text1"] for inst in SingleReader().read(ws["paths"]["train"])]
    tok = WordTokenizer.train_from_corpus(texts, save_path=vocab_path)
    cfg = _classifier_config("config_cnn.json", ws, steps, type="word", vocab_path=str(vocab_path))
    result, train_wall, train_peak, _, _, val_s = _train_classifier(cfg, workdir / "cnn_run")
    epoch = result["history"][0]
    archive = workdir / "cnn_archive.tar.gz"
    shutil.move(result["archive"], archive)
    shutil.rmtree(workdir / "cnn_run")
    text = (ROOT / "configs" / "test_config_cnn.json").read_text()
    metrics, wall, peak, launches, _ = _evaluate_counted(archive, workdir / "test_project.json",
                                                         workdir / "cnn_eval", text)
    recs = _result_records(workdir / "cnn_eval" / "model_cnn_result.json")
    probs = np.array([r["prob"] for r in recs])
    checks = {
        "steps": len(epoch["training_losses"]) == steps,
        "losses_finite": bool(np.isfinite(epoch["training_losses"]).all()),
        "validation_ran": "validation_pos_f1-score" in epoch,
        "records": len(recs) == 512 and bool(np.isfinite(probs).all())
        and probs.min() >= 0.0 and probs.max() <= 1.0,
        "no_attention_kernels": launches == {"flash_attention": 0, "anchor_match": 0},
        "stream_shape": [list(x) for x in metrics["stream_shapes"]] == [[64, 512]],
    }
    checks = {k: bool(v) for k, v in checks.items()}
    line = {
        "ok": all(checks.values()), "checks": checks,
        "config": "configs/config_cnn.json; configs/test_config_cnn.json (verbatim)",
        "reduced": {"steps": steps, "epochs": 1, "sample_neg": 1.0, "vocabulary": tok.vocab_size},
        "train_from_config_wall_s": train_wall,
        **_step_fields(epoch["training_step_durations_s"], epoch["training_padded_tokens"],
                       epoch["training_real_tokens"]),
        "train_peak_memory_gib": train_peak, "validation_s": val_s,
        "validation_f1": epoch["validation_pos_f1-score"], "losses": epoch["training_losses"],
        "scoring": _single_scoring(metrics, recs, wall, peak), "card": nvidia_smi_line(),
    }
    emit("cnn_path", **line)
    if not line["ok"]:
        raise SystemExit(f"cnn_path failed: {checks}")



# the small model trained on the card against the CPU: the largest |Δ| of
# a step's loss, and the relative error of the weights' total update,
# ||Δw_card − Δw_cpu|| / ||Δw_cpu|| (Adam moves every weight by about lr a
# step whatever its gradient's size, so an absolute limit on the weights
# would say nothing).  In f32 (TF32 off) both agree to f32 rounding in
# another order; in bf16 through the wgmma K2 every product rounds
TRAIN_REF_F32 = {"loss_abs": 1e-5, "update_rel": 1e-3}
TRAIN_REF_BF16 = {"loss_abs": 2e-2, "update_rel": 0.25}


def phase_train_reference(steps: int = 4) -> None:
    """The small memory model (2 layers, 2 heads of 64, dropout 0, flash)
    trained ``steps`` optimizer steps by ``train_step`` on the card
    (kernels: K2 under autograd) and on the CPU (plain versions), from the
    same weights on the same pair stacks (K = 2 microbatches of 8 pairs,
    sample1 at 128 tokens, a dedup'd sample2 of 4 rows at 64, random ids
    and key lengths from a seed, one dead microbatch): per-step losses and
    final weights must agree, in f32 (TF32 off) and in bf16 at head dim 64
    through the wgmma K2, to the limits above."""
    import copy

    import numpy as np
    import torch

    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.training.optim import make_optimizer
    from memvul_tpu_torch.training.trainer import train_step

    rng = np.random.default_rng(7)

    def side(rows, length):
        ids = rng.integers(5, 500, size=(2, rows, length))
        mask = np.ones_like(ids)
        for k in range(2):
            for i, n in enumerate(rng.integers(1, length + 1, size=rows)):
                mask[k, i, n:] = 0
        return {"input_ids": ids, "attention_mask": mask}

    stacks = []
    for n in range(steps):
        weight = np.ones((2, 8), np.float32)
        if n == steps - 1:
            weight[1] = 0.0  # a dead microbatch, as the trainer pads tails
        stacks.append({"sample1": side(8, 128), "sample2": side(4, 64),
                       "sample2_index": rng.integers(0, 4, size=(2, 8)),
                       "label": rng.integers(0, 2, size=(2, 8)), "weight": weight})

    def to(stack, device):
        def put(x):
            t = torch.from_numpy(np.asarray(x))
            return (t.long() if t.dtype != torch.float32 else t).to(device)

        return {k: ({kk: put(vv) for kk, vv in v.items()} if isinstance(v, dict) else put(v))
                for k, v in stack.items()}

    results = {}
    for dtype, limits in ((torch.float32, TRAIN_REF_F32), (torch.bfloat16, TRAIN_REF_BF16)):
        cfg = BertConfig(vocab_size=500, hidden_size=128, num_layers=2, num_heads=2,
                         intermediate_size=256, max_position_embeddings=320, attention_impl="flash",
                         dtype=dtype, hidden_dropout=0.0, attention_dropout=0.0)
        torch.manual_seed(0)
        base = MemoryModel(cfg, header_dim=64)
        runs = {}
        for device in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(device).train()
            opt = make_optimizer(model.named_parameters(), base_lr=1e-3, warmup_steps=0,
                                 grad_clip_norm=1.0, group_lrs={"embedder": 5e-4, "pooler": 7e-4})
            launches0 = fa.launches
            losses = [float(train_step(model, opt, to(st, device))["loss"]) for st in stacks]
            runs[device] = {"losses": losses, "launches": fa.launches - launches0,
                            "params": {k: v.detach().float().cpu() for k, v in
                                       model.state_dict().items()}}
        loss_err = max(abs(a - b) for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"]))
        start = {k: v.float() for k, v in base.state_dict().items()}
        diff = torch.cat([(runs["cuda"]["params"][k] - runs["cpu"]["params"][k]).flatten()
                          for k in start])
        moved = torch.cat([(runs["cpu"]["params"][k] - start[k]).flatten() for k in start])
        param_err = float(diff.abs().max())
        update_rel = float(diff.norm() / moved.norm())
        # K2 on the card: 2 layers × 2 towers × 2 microbatches a step
        want_launches = 2 * 2 * 2 * steps
        name = str(dtype).split(".")[-1]
        results[name] = {
            "cuda_losses": runs["cuda"]["losses"], "cpu_losses": runs["cpu"]["losses"],
            "loss_max_abs_err": loss_err, "update_rel_err": update_rel,
            "param_max_abs_err": param_err, "param_max_abs_move": float(moved.abs().max()),
            "k2_launches": runs["cuda"]["launches"], "limits": limits,
            "ok": (loss_err <= limits["loss_abs"] and update_rel <= limits["update_rel"]
                   and runs["cuda"]["launches"] == want_launches
                   and bool(np.isfinite(runs["cuda"]["losses"]).all())),
        }
        if not results[name]["ok"]:
            emit("train_reference", ok=False, results=results)
            raise SystemExit(f"card and CPU training disagree ({name}): {results[name]}")
    emit("train_reference", ok=True, steps=steps, results=results)


# bf16 card-vs-CPU limits of the small model: the largest |Δ| over the live
# tokens' final hidden states, relative to their RMS, and the largest |Δ|
# of a per-anchor probability.  The phase also shows that the hidden-state
# limit would catch a lost key tile.
BF16_HIDDEN_REL = 0.25
BF16_PROBS_ABS = 1e-3


def _small_model(impl: str, dtype, last_layer_only: bool = True):
    """The reference phases' small memory model (2 layers, 2 heads of 64)
    from a seed.  In bf16 the attention weights are scaled up, so each
    softmax is peaked and the attention branch weighs in the residual
    stream.  ``last_layer_only=False`` mixes the layers with ScalarMix,
    its weights and gamma drawn away from their init."""
    import torch

    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel

    cfg = BertConfig(
        vocab_size=500, hidden_size=128, num_layers=2, num_heads=2,
        intermediate_size=256, max_position_embeddings=320, attention_impl=impl,
        dtype=dtype, last_layer_only=last_layer_only,
    )
    torch.manual_seed(0)
    model = MemoryModel(cfg, header_dim=64).eval()
    if not last_layer_only:
        with torch.no_grad():
            model.bert.scalar_mix.scalar_weights.copy_(torch.tensor([0.7, -0.4]))
            model.bert.scalar_mix.gamma.fill_(1.3)
    if dtype == torch.bfloat16:
        with torch.no_grad():
            for layer in model.bert.encoder.layer:
                # scores of spread about 4 instead of about 0.05
                attention = layer.attention
                attention.self.query.weight.mul_(9.0)
                attention.self.key.weight.mul_(9.0)
                attention.self.value.weight.mul_(4.0)
                attention.output.dense.weight.mul_(4.0)
    return model


def phase_main_path_reference() -> None:
    """A small memory model scored on the card (kernels) and on the CPU
    (plain versions), which must agree: in f32 through both attention impls
    and with ScalarMix over its layers (per-anchor probabilities, and the
    mixed hidden states, to rtol 1e-4 / atol 1e-5), and in bf16 at head
    dim 64 through flash, the main path's tensor-core kernel, with the
    attention weights scaled up so each softmax is peaked and the attention
    branch weighs in the residual stream (the final hidden states and the
    probabilities, to the limits above)."""
    import numpy as np
    import torch

    from memvul_tpu_torch.models.memory import anchor_probs
    from memvul_tpu_torch.ops.attention import mask_to_bias

    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(5, 500, size=(9, 300)))
    mask = torch.ones_like(ids)
    for i, n in enumerate(rng.integers(1, 301, size=9)):
        mask[i, n:] = 0
    bank_ids = torch.as_tensor(rng.integers(5, 500, size=(7, 300)))
    bank_mask = torch.ones_like(bank_ids)
    live = mask.bool()

    results = {}
    for impl, dtype, last_only in (("flash", torch.float32, True), ("xla", torch.float32, True),
                                   ("flash", torch.float32, False), ("flash", torch.bfloat16, True)):
        model = _small_model(impl, dtype, last_only)
        out, hidden = {}, {}
        for device in ("cpu", "cuda"):
            m = model.to(device)
            with torch.no_grad():
                bank = m.encode(bank_ids.to(device), bank_mask.to(device))
                u = m.encode(ids.to(device), mask.to(device))
                out[device] = anchor_probs(m.match_anchors(u, bank)).cpu()
                hidden[device] = m.bert(ids.to(device), mask.to(device)).cpu().float()[live]
        name = f"{impl}_{str(dtype).split('.')[-1]}" + ("" if last_only else "_scalar_mix")
        if dtype == torch.float32:
            err, ok = max_err(out["cuda"], out["cpu"], 1e-5, 1e-4)
            results[name] = {"max_abs_err": err, "ok": ok}
            if not last_only:
                # the mixed hidden states, and the check's power: the last
                # layer alone must differ from the mix
                h_err, h_ok = max_err(hidden["cuda"], hidden["cpu"], 1e-5, 1e-4)
                with torch.no_grad():
                    last = model.to("cpu").bert.encoder(
                        model.bert.embeddings(ids, torch.zeros_like(ids)),
                        mask_to_bias(mask, dtype))[-1].float()[live]
                results[name].update(hidden_max_abs_err=h_err,
                                     last_layer_vs_mix=max_err(last, hidden["cpu"], 0.0, 0.0)[0])
                ok = ok and h_ok and results[name]["last_layer_vs_mix"] > 1e-2
                results[name]["ok"] = ok
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


def phase_ragged_reference() -> None:
    """The small model served ragged: one pack of 7 requests (a budget of
    2400, not a tile multiple, with a dead tail) scored on the card and on
    the CPU, which must agree.  In f32 the pack goes through the ragged
    kernel's CUDA-core path (per-anchor probabilities to 1e-5); in bf16 at
    head dim 64 through its tensor-core path, to the bf16 limits above,
    with the check shown to catch a kernel that lost the first key tile of
    every request and one that leaked across requests."""
    import numpy as np
    import torch

    from memvul_tpu_torch.data.batching import collate_ragged
    from memvul_tpu_torch.models.memory import anchor_probs

    rng = np.random.default_rng(5)
    rows = 7
    seqs = [list(rng.integers(5, 500, size=int(n))) for n in rng.integers(1, 301, size=rows)]
    sample = {k: torch.as_tensor(v).long() for k, v in collate_ragged(seqs, 2400, 8, pad_id=0).items()}
    bank_ids = torch.as_tensor(rng.integers(5, 500, size=(7, 300)))
    bank_mask = torch.ones_like(bank_ids)
    seg = sample["segment_ids"]
    live = seg[0] > 0
    # a kernel that lost a key tile (the first 64 tokens of every request
    # cut off from the rest of it), and one that leaked across requests
    # (every live token in one segment)
    lost_seg = seg.clone()
    for s_id in torch.unique(seg[seg > 0]).tolist():
        lost_seg[0, torch.nonzero(seg[0] == s_id)[:64, 0]] = s_id + 1000
    leak_seg = (seg > 0).long()

    def hidden_of(m, s, segment_ids, device):
        return m.bert(s["input_ids"], s["attention_mask"], position_ids=s["position_ids"],
                      segment_ids=segment_ids.to(device))[0].float().cpu()[live]

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _small_model("flash", dtype)
        out, hidden = {}, {}
        for device in ("cpu", "cuda"):
            m = model.to(device)
            s = {k: v.to(device) for k, v in sample.items()}
            with torch.no_grad():
                bank = m.encode(bank_ids.to(device), bank_mask.to(device))
                out[device] = anchor_probs(m.score_ragged(s, bank)).cpu()[:rows]
                hidden[device] = hidden_of(m, s, seg, device)
        name = f"ragged_{str(dtype).split('.')[-1]}"
        if dtype == torch.float32:
            err, ok = max_err(out["cuda"], out["cpu"], 1e-5, 0.0)
            results[name] = {"max_abs_err": err, "ok": ok}
        else:
            err, _ = max_err(out["cuda"], out["cpu"], 0.0, 0.0)
            h_err, _ = max_err(hidden["cuda"], hidden["cpu"], 0.0, 0.0)
            h_rel = h_err / rms(hidden["cpu"])
            with torch.no_grad():
                lost, leak = (hidden_of(model.to("cpu"), sample, s, "cpu") for s in (lost_seg, leak_seg))
            lost_rel, leak_rel = (max_err(x, hidden["cpu"], 0.0, 0.0)[0] / rms(hidden["cpu"])
                                  for x in (lost, leak))
            ok = (err <= BF16_PROBS_ABS and h_rel <= BF16_HIDDEN_REL
                  and BF16_HIDDEN_REL < min(lost_rel, leak_rel))
            results[name] = {"max_abs_err": err, "hidden_max_abs_err": h_err,
                             "hidden_err_over_rms": h_rel, "lost_tile_hidden_err_over_rms": lost_rel,
                             "leak_hidden_err_over_rms": leak_rel, "ok": ok}
        if not ok:
            emit("ragged_reference", ok=False, results=results)
            raise SystemExit(f"card and CPU disagree on the small ragged model ({name}): {results[name]}")
    emit("ragged_reference", ok=True, rows=rows, token_budget=2400,
         row_tokens=[len(s) for s in seqs],
         tol={"f32": {"atol": 1e-5},
              "bf16": {"hidden_err_over_rms": BF16_HIDDEN_REL, "probs_abs": BF16_PROBS_ABS}},
         results=results)


# -- slice 8: sharded corpus scoring, the anchor-bank lifecycle, selfcheck ------

SCORE_CORPUS_CHAOS = ("shard.kill.shard-1@3=sigkill;"
                      "score.batch@2=raise:RuntimeError:UNAVAILABLE injected")


def _shard_telemetry(shard_dir: Path) -> dict:
    return json.loads((shard_dir / "telemetry.json").read_text())


def phase_score_corpus_path(workdir: Path, records: dict, shards: int = 2) -> dict:
    """``score_corpus`` of the main path's archive and 512 reports with
    ``configs/test_config_memory.json``'s evaluation section (auto-8
    buckets, warmup) on ``shards`` workers sharing the card, under the
    chaos string (shard-1 SIGKILLed at its third row, a transient
    ``score.batch`` fault retried), against a single-process
    ``evaluate_from_archive`` of the same overrides: merged records
    byte-identical by report, the same metric file.  Each worker's K1 and K2
    launches (read back from its ``telemetry.json``) must equal what its
    warmup, batches and anchor chunks need.  Returns the result and the
    single-process records."""
    import os

    from memvul_tpu_torch.config import loads_config, merge_overrides
    from memvul_tpu_torch.distributed import score_corpus
    from memvul_tpu_torch.resilience import faults

    archive, test_path = workdir / "model.tar.gz", workdir / "test_project.json"
    overrides = merge_overrides(
        loads_config((ROOT / "configs" / "test_config_memory.json").read_text()),
        {"evaluation": {"score_retries": 2, "heartbeat_batches": 1}})
    single, single_wall, single_peak, single_launches, _ = _evaluate_counted(
        archive, test_path, workdir / "eval_single", overrides)
    single_recs = _result_records(workdir / "eval_single" / "model_memory_result.json")
    faults.configure(None)  # this process arms nothing; the workers read the env
    os.environ["MEMVUL_FAULTS"] = SCORE_CORPUS_CHAOS
    try:
        t0 = time.perf_counter()
        result = score_corpus(archive, test_path, workdir / "score_corpus", shards=shards,
                              overrides=overrides, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MEMVUL_FAULTS", None)
    merged = _result_records(Path(result["out_results"]))
    by_url = {r["Issue_Url"]: r for r in single_recs}
    mismatched = [r["Issue_Url"] for r in merged
                  if json.dumps(r) != json.dumps(by_url.get(r["Issue_Url"]))]
    worst, flips = 0.0, 0
    for url in mismatched:
        a, b = by_url.get(url), next(r for r in merged if r["Issue_Url"] == url)
        if a is None:
            continue
        worst = max(worst, max(abs(a["predict"][k] - b["predict"][k]) for k in a["predict"]))
        flips += (max(a["predict"].values()) >= 0.5) != (max(b["predict"].values()) >= 0.5)
    workers = {}
    for sh in result["shards"]:
        shard_dir = workdir / "score_corpus" / sh["shard"]
        tel = _shard_telemetry(shard_dir)
        m = json.loads((shard_dir / "shard_metrics.json").read_text())["metrics"]
        warm = len(m["stream_shapes"])  # aot_warmup runs each stream shape once
        want = {"flash_attention": 12 * (warm + int(m["batches"]) + int(m["anchor_chunks"])),
                "anchor_match": warm + int(m["batches"])}
        got = {k: int(tel["counters"].get(f"kernels.launches.{k}", -1)) for k in want}
        workers[sh["shard"]] = {
            "span": sh["span"], "attempts": sh["attempts"], "failures": sh["failures"],
            "launches": got, "want_launches": want, "batches": m["batches"],
            "retries": tel["counters"].get("resilience.retries", 0),
            "scoring_s": m["elapsed_s"],
            "peak_memory_gib": tel["gauges"].get("device.peak_bytes", 0.0) / 2**30,
        }
    checks = {
        "restarted": result["restarts"] >= 1 and workers["shard-1"]["attempts"] == 2,
        "exactly_once": result["verification"]["exactly_once"]
        and result["corpus_rows"] == len(merged) == len(single_recs),
        "records_byte_identical": not mismatched,
        "metrics_byte_identical": Path(result["out_metrics"]).read_bytes()
        == (workdir / "eval_single" / "model_memory_metric_all.json").read_bytes(),
        "transient_fault_retried": sum(w["retries"] for w in workers.values()) >= 1,
        "worker_launches": all(w["launches"] == w["want_launches"] for w in workers.values()),
        "same_buckets": list(result["buckets"]) == [length for _, length in single["s_stream_shapes"]],
    }
    reports = len(merged)
    line = dict(
        ok=all(checks.values()), checks=checks, shards=shards, chaos=SCORE_CORPUS_CHAOS,
        config="configs/test_config_memory.json (+ score_retries 2)", reports=reports,
        buckets=result["buckets"], restarts=result["restarts"], wall_s=wall,
        reports_per_s=reports / wall, merge_wall_s=result["merge_wall_s"], workers=workers,
        single_process={"wall_s": single_wall, "reports_per_s": reports / single_wall,
                        "scoring_s": single["s_elapsed_s"],
                        "scoring_reports_per_s": reports / single["s_elapsed_s"],
                        "peak_memory_gib": single_peak, "launches": single_launches},
        mismatched_records=len(mismatched), max_abs_diff=worst, decisions_flipped=flips,
        card=nvidia_smi_line(),
    )
    emit("score_corpus_path", **line)
    if not line["ok"]:
        raise SystemExit(f"score_corpus_path failed: {checks}")
    for w in workers.values():
        records["flash_attention"]["launches"] += w["launches"]["flash_attention"]
        records["anchor_match"]["launches"] += w["launches"]["anchor_match"]
    return result


def _cli_json(argv: list):
    """``python -m memvul_tpu_torch`` in this process: (exit code, the JSON
    it printed)."""
    import contextlib
    import io

    from memvul_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, json.loads(out.getvalue())


def _burst(service, texts: list) -> list:
    """Every text queued while the batcher waits on the queue's lock, then
    released: the batcher pulls them in order, ``max_batch`` at a time, so
    two bursts of the same texts pack the same requests the same way."""
    with service._cond:
        futures = [service.submit(t) for t in texts]
    return [f.result(120.0) for f in futures]


def phase_bank_path(workdir: Path, records: dict, corpus_result: dict, requests: int = 256,
                    golden_reports: int = 128) -> None:
    """The anchor-bank lifecycle on the main path's archive: ``bank build``
    of its 129 anchors, ``bank diff`` (retire 8, and reweight to 0.5 the 4
    categories that win most often in ``score_corpus_path``: A = 121),
    ``bank shadow`` replaying ``score_corpus_path``'s merged results
    against v2 and ``bank promote`` with the default thresholds (its
    decision reported as it is); then a live ragged ``ScoringService``
    serving ``requests`` texts without and with a ``ShadowScorer`` of v2
    (answers bitwise the same, every request shadow-scored through K3 at the
    new A), ``promote`` of v2 (served answers equal to v2's offline scores, the
    winners its weighted ``argmax``),
    ``demote``; and ``evaluate_cascade`` on ``golden_reports`` labeled
    reports through the int8 tier.  K1 is held against its plain version at
    A = 121 at the row counts these paths launch it with, and K2 at the
    replay's ``[16, 512]``."""
    import numpy as np
    import torch

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.bankops import (
        BankStore, GateThresholds, ShadowConfig, ShadowScorer, demote, evaluate_candidate,
        evaluate_cascade, promote)
    from memvul_tpu_torch.build import build_reader
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.serving import ScoringService, ServiceConfig

    archive, test_path = workdir / "model.tar.gz", workdir / "test_project.json"
    store_dir = workdir / "banks"
    anchors = json.loads((workdir / "CWE_anchor_golden_project.json").read_text())
    t0 = time.perf_counter()
    rc, built = _cli_json(["bank", "build", "--store", str(store_dir), "--anchors",
                           str(workdir / "CWE_anchor_golden_project.json")])
    labels = sorted(anchors)
    # reweight the 4 kept categories that win most often in the sharded
    # run: halving them changes served winners, so the promoted bank's
    # weighted selection shows on the card
    wins = collections.Counter(max(r["predict"], key=r["predict"].get)
                               for r in _result_records(Path(corpus_result["out_results"])))
    reweighted = sorted(labels[8:], key=lambda c: (-wins[c], c))[:4]
    diff = ["bank", "diff", "--store", str(store_dir)]
    for cat in labels[:8]:
        diff += ["--retire", cat]
    for cat in reweighted:
        diff += ["--reweight", f"{cat}=0.5"]
    rc_diff, derived = _cli_json(diff)
    store = BankStore(store_dir)
    cli_s = {"build_and_diff": time.perf_counter() - t0}
    common = ["--store", str(store_dir), "--candidate", "v2", "--archive", str(archive),
              "--device", "cuda"]
    fa.launches = am.launches = 0
    t0 = time.perf_counter()
    rc_shadow, replay = _cli_json(["bank", "shadow", *common, "--corpus", str(test_path),
                                   "--results", corpus_result["out_results"],
                                   "-o", str(workdir / "bank_shadow")])
    cli_s["shadow"] = time.perf_counter() - t0
    replay_launches = {"flash_attention": fa.launches, "anchor_match": am.launches}
    t0 = time.perf_counter()
    rc_promote, cli_decision = _cli_json(["bank", "promote", *common, "--golden-set",
                                          str(test_path), "--shadow-summary",
                                          str(workdir / "bank_shadow" / "shadow_summary.json")])
    cli_s["promote"] = time.perf_counter() - t0
    cli_ok = (rc == rc_diff == rc_shadow == 0 and rc_promote in (0, 1)
              and built["n_anchors"] == 129 and derived["n_anchors"] == 121
              and replay["sampled"] == corpus_result["corpus_rows"]
              and cli_decision["approved"] == (rc_promote == 0))

    # the live service: ragged packs (K3), the shadow tap, promote, demote
    arch = load_archive(archive, device="cuda")
    reader = build_reader(arch.config.get("dataset_reader"))
    predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=16, max_length=512,
                                 score_impl="ragged", token_budget=2048, max_rows_per_pack=16)
    predictor.encode_anchors(reader.read_anchors(str(workdir / "CWE_anchor_golden_project.json")))
    predictor.warmup_compile()
    service = ScoringService(predictor, config=ServiceConfig(
        max_batch=16, max_wait_ms=5.0, max_queue=requests, default_deadline_ms=60000.0))
    texts = corpus_texts(json.loads(test_path.read_text()))[:requests]
    try:
        t0 = time.perf_counter()
        plain = _burst(service, texts)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scorer = ShadowScorer(service, store.instances("v2"), out_dir=workdir / "bank_live",
                              config=ShadowConfig(max_queue=4 * requests), candidate_version="v2")
        attach_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        ra.launches = fa.launches = am.launches = 0
        served_before = service.registry.counter("serve.batches").value
        t0 = time.perf_counter()
        tapped = _burst(service, texts)
        tapped_s = time.perf_counter() - t0
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and \
                service.registry.counter("bank.shadow_sampled").value < len(texts):
            time.sleep(0.01)
        live = scorer.stop()
        torch.cuda.synchronize()
        packs = service.registry.counter("serve.batches").value - served_before
        shadow_launches = {"ragged": ra.launches, "anchor_match": am.launches,
                           "flash": fa.launches}
        bitwise = all(a["status"] == b["status"] == "ok" and a["predict"] == b["predict"]
                      and a["anchor"] == b["anchor"] for a, b in zip(plain, tapped))

        decision = evaluate_candidate(
            predictor, store, "v2", list(reader.read(str(test_path)))[:golden_reports],
            shadow_summary=live,
            # the smoke drives the install path whatever random weights score
            thresholds=GateThresholds(max_auc_drop=1.0, max_f1_drop=1.0, max_flip_rate=1.0,
                                      min_shadow_samples=1))
        serving_version = promote(service, store, decision)
        promoted = _burst(service, texts[:64])
        v2_bank, v2_labels, n = predictor.encode_bank(store.instances("v2"))
        offline = predictor.score_texts(texts[:64], v2_bank, n)
        got = np.array([[r["predict"][a] for a in v2_labels] for r in promoted], np.float64)
        promoted_err = float(np.abs(got - offline).max())
        # v2 reweights 4 categories: the served winner is the weighted argmax
        # of the raw probabilities, and agrees with the offline weighted
        # winner wherever the weighted top two are apart by more than the
        # tolerance
        weights = np.array([float((inst.get("meta") or {}).get("weight", 1.0))
                            for inst in store.instances("v2")])
        weighted_bank = service.bank_snapshot().weights is not None
        winners = (got * weights).argmax(axis=1)
        offline_w = offline * weights
        top2 = np.sort(offline_w, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_SERVE_PROBS_ABS
        weighted_winners = (
            [r["anchor"] for r in promoted] == [v2_labels[i] for i in winners]
            and [r["score"] for r in promoted] == [float(got[i, w]) for i, w in enumerate(winners)]
            and bool((winners == offline_w.argmax(axis=1))[clear].all()))
        reweight_changes = int((winners != got.argmax(axis=1)).sum())
        demoted = demote(service, store)
        after = _burst(service, texts[:16])
    finally:
        service.drain()
    checks = {
        "cli": cli_ok,
        "served_bitwise_with_tap": bitwise,
        "every_request_shadowed": live["sampled"] == len(texts) and live["errors"] == 0,
        "shadow_through_k3": shadow_launches["ragged"] > 12 * packs
        and shadow_launches["anchor_match"] > packs,
        "promoted": serving_version == 2 and all(r["bank_version"] == 2 for r in promoted)
        and promoted_err <= BF16_SERVE_PROBS_ABS,
        "promoted_weighted_winners": weighted_bank and weighted_winners and reweight_changes > 0,
        "demoted": demoted == {"version": "v1", "serving_version": 3}
        and all(r["bank_version"] == 3 and len(r["predict"]) == 129 for r in after),
        "active_pointer": store.active()["version"] == "v1",
    }

    # evaluate_cascade: the int8 tier over the golden reports
    cascade_pred = SiamesePredictor(arch.model, arch.tokenizer, batch_size=16, max_length=512,
                                    encoder_precision="int8", score_impl="cascade")
    cascade_pred.encode_anchors(reader.read_anchors(str(workdir / "CWE_anchor_golden_project.json")))
    t0 = time.perf_counter()
    cascade = evaluate_cascade(cascade_pred, list(reader.read(str(test_path)))[:golden_reports])
    cascade_s = time.perf_counter() - t0
    checks["cascade_decided"] = cascade.metrics["shadow"]["sampled"] == golden_reports
    del cascade_pred, predictor, service, arch
    torch.cuda.empty_cache()

    # K1 at the candidate's A = 121, at every row count these paths used
    k1 = _anchor_match_at_rows([16], a=121)
    k2 = _flash_at_auto_shapes([(16, 512)], records)
    line = dict(
        ok=all(checks.values()), checks=checks,
        anchors={"v1": 129, "v2": 121, "reweighted_to_0.5": reweighted},
        cli={"exit_codes": {"build": rc, "diff": rc_diff, "shadow": rc_shadow,
                            "promote": rc_promote}, "seconds": cli_s,
             "replay": replay, "replay_launches": replay_launches,
             "promote_decision": {k: cli_decision[k] for k in ("approved", "reasons")}},
        live={"requests": len(texts), "plain_s": plain_s, "tapped_s": tapped_s,
              "plain_requests_per_s": len(texts) / plain_s,
              "tapped_requests_per_s": len(texts) / tapped_s, "attach_and_warm_s": attach_s,
              "packs": packs, "shadow": live, "launches": shadow_launches,
              "promoted_max_abs_err": promoted_err, "tol": BF16_SERVE_PROBS_ABS,
              "promoted_clear_winners": int(clear.sum()),
              "promoted_reweight_winner_changes": reweight_changes,
              "gate_approved": decision.approved},
        cascade={"reports": golden_reports, "approved": cascade.approved,
                 "reasons": cascade.reasons, "flip_rate": cascade.metrics["shadow"]["flip_rate"],
                 "max_abs_delta": cascade.metrics["shadow"]["max_abs_delta"],
                 "seconds": cascade_s},
        kernel_anchor_match_a121=k1, kernel_flash_replay_shape=k2, card=nvidia_smi_line(),
    )
    emit("bank_path", **line)
    if not line["ok"]:
        raise SystemExit(f"bank_path failed: {checks}")
    records["ragged_flash_attention"]["launches"] += shadow_launches["ragged"]
    records["anchor_match"]["launches"] += shadow_launches["anchor_match"] \
        + replay_launches["anchor_match"]
    records["flash_attention"]["launches"] += replay_launches["flash_attention"]


class _TenantSplit:
    """A load target that sends every other request to ``tenant``."""

    def __init__(self, router, tenant: str) -> None:
        self.router, self.tenant = router, tenant
        self.replicas, self._tel = router.replicas, router.registry
        self._n = 0
        self._lock = threading.Lock()
        self.sent = []  # (tenant or None, text, future), in submit order

    def submit(self, text, deadline_ms=None):
        with self._lock:
            tenant = self.tenant if self._n % 2 else None
            self._n += 1
        future = self.router.submit(text, deadline_ms=deadline_ms, tenant=tenant)
        with self._lock:
            self.sent.append((tenant, text, future))
        return future


def phase_fleet_path(workdir: Path, records: dict, serve_runs: dict, requests: int = 256,
                     clients: int = 16, kill_at: int = 64, swap_at: int = 128,
                     ab_rounds: int = 2) -> float:
    """The serving plane's fleet on the main path's archive:
    ``serve_from_archive`` with ``score_impl`` "ragged", ``replicas`` 2 (both
    on this card, each on a CUDA stream of its own), tracing on; packs of
    2048 tokens and 16 rows.  Five steps, each on ``requests`` texts of the
    main path's corpus through ``loadgen``:

    1. a closed loop of ``clients`` clients (``run_slo_harness``): requests/s,
       latency, per-replica served, packs, token utilization, the SLO block;
       then ``ab_rounds`` rounds, in turns, of the same loop on the fleet, on
       a fleet whose two replicas share the default stream, and on one
       replica, beside ``serve_path``'s single-service ragged rate;
    2. the same loop with ``replica.kill`` armed on replica-1 at its
       ``kill_at``-th submit: one kill, one restart, no hang, nothing past
       its deadline, the fleet invariant, answers within
       ``BF16_SERVE_PROBS_ABS`` of the bucketed ``score_texts``;
    3. ``rolling_swap`` to ``bank_path``'s candidate (A = 121) started at
       about the ``swap_at``-th request, replica-1 killed while replica-0's
       install is done: one bank version per response, the fleet version 2
       only once the live replicas serve it, the killed replica back on
       version 2, answers under version 2 the weighted winners of the
       candidate's offline scores;
    4. a second fleet with tenants (``default``: 129 anchors, ``acme``: the
       candidate) and ``cache_capacity`` 256 under ``dedup`` traffic, half per
       tenant: each tenant's answers from its own bank, a swap of ``acme``
       leaving ``default``'s alone, cache hits bitwise their misses and adding
       no pack (K3 == 12 × packs, K1 == packs);
    5. the front end over both fleets: ``/healthz`` (both replicas),
       ``/metrics`` (per-replica labels, ``router.*``), ``/tracez`` (step 2's
       rerouted request with its hops), ``POST /score`` with
       ``X-MemVul-Tenant: acme``.

    The kernels' counts are set to 0 at the start and read at the end; the
    oracle's launches (bucketed ``score_texts``) are taken out.  K2 is then
    held against its plain version at the bank encode's ``[128, 512]``."""
    import statistics
    import urllib.request

    import numpy as np
    import torch

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.bankops import BankStore
    from memvul_tpu_torch.build import build_reader, serve_from_archive
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.resilience import faults
    from memvul_tpu_torch.serving import (
        REPLICA_DEAD, REPLICA_HEALTHY, HTTPClient, LoadConfig, Replica, ReplicaRouter,
        RouterConfig, ScoringService, ServiceConfig, fleet_snapshot, rolling_swap,
        run_slo_harness)
    from memvul_tpu_torch.serving.frontend import run_http_server
    from memvul_tpu_torch.telemetry.exposition import parse_exposition

    layers = 12
    archive = workdir / "model.tar.gz"
    golden = workdir / "CWE_anchor_golden_project.json"
    texts = corpus_texts(json.loads((workdir / "test_project.json").read_text()))[:requests]
    store = BankStore(workdir / "banks")  # bank_path's: v1 (129), v2 (retire 8, reweight 4)
    v2 = store.instances("v2")
    overrides = {"serving": {"score_impl": "ragged", "replicas": 2, "trace_sample_rate": 1.0,
                             "trace_ring": 4096, "default_deadline_ms": 30000}}

    def counts():
        return {"ragged": ra.launches, "flash": fa.launches, "anchor_match": am.launches}

    oracle_launches = collections.Counter()

    def oracle(fn):
        before = counts()
        out = fn()
        oracle_launches.update({k: v - before[k] for k, v in counts().items()})
        return out

    def batches(router):
        return sum(r.registry.counter("serve.batches").value for r in router.replicas)

    def probs(r, labels):
        return np.array([r["predict"][a] for a in labels], np.float64)

    checks, out = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ra.launches = fa.launches = am.launches = 0
    t0 = time.perf_counter()
    fleet = serve_from_archive(archive, device="cuda", overrides=overrides)
    out["build_s"] = time.perf_counter() - t0
    r0, r1 = fleet.replicas
    pred0 = r0.service.predictor
    labels = list(pred0.anchor_labels)
    checks["one_card_shared_weights"] = (pred0.model is r1.service.predictor.model
                                        and pred0.stream is not None
                                        and pred0.stream != r1.service.predictor.stream)
    want = oracle(lambda: pred0.score_texts(texts, impl="bucketed"))
    want_by_text = {t: row for t, row in zip(texts, want)}
    load = LoadConfig(pattern="closed", requests=requests, clients=clients,
                      result_timeout_s=120.0)

    # -- 1. the closed loop ----------------------------------------------------
    before, packs_before = counts(), batches(fleet)
    record = run_slo_harness(fleet, texts, load)
    after, packs = counts(), batches(fleet) - packs_before
    snaps = [r.registry.snapshot()["counters"] for r in fleet.replicas]
    real = sum(c["serve.tokens_real"] for c in snaps)
    padded = sum(c["serve.tokens_padded"] for c in snaps)
    step1 = {
        "requests_per_s": record["load"]["achieved_rps"],
        "latency_ms": record["load"]["latency_ms"], "outcomes": record["load"]["outcomes"],
        "served_by_replica": {m["name"]: m["served"] for m in record["fleet"]["replicas"]},
        "packs": packs, "token_utilization": real / padded, "slo": record.get("slo"),
        "router": record["router"],
        "serve_path_single_ragged_requests_per_s": serve_runs["ragged"]["requests_per_s"],
    }
    checks["closed_loop_all_ok"] = record["load"]["outcomes"]["ok"] == requests
    checks["closed_loop_both_replicas"] = min(step1["served_by_replica"].values()) > 0
    checks["closed_loop_k3_eq_12x_packs"] = after["ragged"] - before["ragged"] == layers * packs
    checks["closed_loop_k1_eq_packs"] = after["anchor_match"] - before["anchor_match"] == packs
    out["closed_loop"] = step1

    # the stream A/B, in turns: this fleet (a stream per replica), a fleet
    # whose two replicas launch on the default stream, one replica alone
    arch = load_archive(archive, device="cuda")
    anchors = list(build_reader(arch.config.get("dataset_reader")).read_anchors(str(golden)))

    def default_stream_factory(registry):
        predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=16, max_length=512,
                                     score_impl="ragged", token_budget=2048, max_rows_per_pack=16)
        predictor.encode_anchors(anchors)
        predictor.warmup_compile()
        return ScoringService(predictor, config=ServiceConfig(
            max_batch=16, max_wait_ms=5.0, max_queue=256, default_deadline_ms=30000.0),
            registry=registry)

    shared = ReplicaRouter([Replica(i, default_stream_factory) for i in range(2)])
    rates = {"fleet_stream_per_replica": [], "fleet_default_stream": [], "one_replica": []}
    ab_packs = {name: [] for name in rates}
    ab_before = counts()

    def packs_of(target):
        registries = [r.registry for r in target.replicas] if hasattr(target, "replicas") \
            else [target.registry]
        return sum(reg.counter("serve.batches").value for reg in registries)

    for _ in range(ab_rounds):
        for name, target in (("fleet_stream_per_replica", fleet),
                             ("fleet_default_stream", shared), ("one_replica", r0.service)):
            packs_before = packs_of(target)
            rates[name].append(run_slo_harness(target, texts, load)["load"]["achieved_rps"])
            ab_packs[name].append(packs_of(target) - packs_before)
    shared.drain()
    del shared
    ab_launches = {k: v - ab_before[k] for k, v in counts().items()}
    out["stream_ab"] = {"rounds": ab_rounds, "requests_per_s": rates, "packs": ab_packs,
                        "median_requests_per_s": {k: statistics.median(v)
                                                  for k, v in rates.items()},
                        "launches": ab_launches}

    # -- 2. chaos: replica-1 killed at its kill_at-th submit --------------------
    state = {"dead_at": None, "back_at": None}
    stop = threading.Event()

    def watch(replica):
        while not stop.is_set():
            if state["dead_at"] is None and replica.state == REPLICA_DEAD:
                state["dead_at"] = time.monotonic()
            if state["dead_at"] is not None and replica.state == REPLICA_HEALTHY \
                    and replica.restart_count >= 1:
                state["back_at"] = time.monotonic()
                return
            time.sleep(0.002)

    watcher = threading.Thread(target=watch, args=(r1,), daemon=True)
    watcher.start()
    kills_before = r1.registry.counter("replica.kills").value
    faults.configure(f"replica.kill.replica-1@{kill_at}=raise:RuntimeError:chaos kill")
    sent = []
    gen_submit = fleet.submit

    def tracking_submit(text, deadline_ms=None):
        future = gen_submit(text, deadline_ms=deadline_ms)
        sent.append((text, future))
        return future

    from memvul_tpu_torch.serving import LoadGenerator

    chaos = LoadGenerator(tracking_submit, load).run(texts)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and state["back_at"] is None:
        time.sleep(0.01)
    stop.set()
    faults.reset()
    responses = [f.result(1.0) for _, f in sent]
    ok = [(t, r) for (t, _), r in zip(sent, responses) if r["status"] == "ok"]
    chaos_err = max((float(np.abs(probs(r, labels) - want_by_text[t]).max()) for t, r in ok),
                    default=0.0)
    rerouted = [r for r in responses if r.get("reroutes")]
    snap = fleet_snapshot(fleet.replicas)
    out["chaos"] = {
        "outcomes": chaos["outcomes"], "requests_per_s": chaos["achieved_rps"],
        "latency_ms": chaos["latency_ms"], "rerouted": len(rerouted),
        "kills": r1.registry.counter("replica.kills").value - kills_before,
        "restarts": r1.restart_count,
        "recovery_s": (state["back_at"] - state["dead_at"]) if state["back_at"] else None,
        "max_abs_err": chaos_err, "tol": BF16_SERVE_PROBS_ABS, "fleet": snap,
    }
    checks["chaos_one_kill_one_restart"] = out["chaos"]["kills"] == 1 and r1.restart_count == 1
    checks["chaos_no_hang_no_deadline"] = (chaos["outcomes"]["hang"] == 0
                                           and chaos["outcomes"]["deadline"] == 0
                                           and chaos["outcomes"]["ok"] == requests)
    checks["chaos_invariant"] = snap["invariant_ok"]
    checks["chaos_answers"] = len(ok) == requests and chaos_err <= BF16_SERVE_PROBS_ABS
    checks["chaos_rerouted"] = len(rerouted) >= 1

    # -- 3. rolling swap to the candidate under load ----------------------------
    v2_weights = np.array([float((i.get("meta") or {}).get("weight", 1.0)) for i in v2])
    seen = {}
    sent.clear()
    requests_before = fleet.registry.counter("router.requests").value
    swap = {}

    def swap_when_due():
        while fleet.registry.counter("router.requests").value - requests_before < swap_at:
            time.sleep(0.001)
        t1 = time.perf_counter()
        swap["version"] = rolling_swap(fleet, v2, source="rolling_swap", store_version="v2")
        swap["wall_s"] = time.perf_counter() - t1

    def kill_mid_rollout():
        # replica-1 dies once replica-0 serves v2 again, while the rollout runs
        while not (r0.bank_version == 2 and r0.accepting.is_set()):
            time.sleep(0.0005)
        seen["fleet_version_at_kill"] = fleet.bank_version
        seen["rollout_running_at_kill"] = "version" not in swap
        r1.kill(reason="killed during the rollout")

    killer = threading.Thread(target=kill_mid_rollout, daemon=True)
    killer.start()
    swapper = threading.Thread(target=swap_when_due, daemon=True)
    swapper.start()
    roll = LoadGenerator(tracking_submit, load).run(texts)
    swapper.join(300)
    killer.join(300)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (r1.state == REPLICA_HEALTHY
                                               and r1.bank_version == 2):
        time.sleep(0.01)
    v2_labels = [i["meta"]["label"] for i in v2]
    during = [r.result(1.0) for _, r in sent]
    torn = [r for r in during if r["status"] == "ok" and not (
        (r["bank_version"] == 1 and sorted(r["predict"]) == sorted(labels))
        or (r["bank_version"] == 2 and sorted(r["predict"]) == sorted(v2_labels)))]
    after_texts = texts[:64]
    followed = [fleet.submit(t).result(120.0) for t in after_texts]
    v2_bank, _, n_v2 = oracle(lambda: pred0.encode_bank(v2))
    offline = oracle(lambda: pred0.score_texts(after_texts, v2_bank, n_v2, impl="bucketed"))
    got = np.array([probs(r, v2_labels) for r in followed])
    v2_err = float(np.abs(got - offline).max())
    winners = (got * v2_weights).argmax(axis=1)
    out["rolling_swap"] = {
        "wall_s": swap.get("wall_s"), "outcomes": roll["outcomes"],
        "requests_per_s": roll["achieved_rps"],
        "versions_during": dict(collections.Counter(r.get("bank_version") for r in during)),
        "fleet_version_at_kill": seen.get("fleet_version_at_kill"),
        "rollout_running_at_kill": seen.get("rollout_running_at_kill"),
        "replica_versions": [r.bank_version for r in fleet.replicas],
        "restarts_replica_1": r1.restart_count, "v2_max_abs_err": v2_err,
    }
    checks["swap_one_version_per_response"] = not torn and roll["outcomes"]["hang"] == 0
    checks["swap_version_after_live_replicas"] = (swap.get("version") == 2
                                                  and seen.get("fleet_version_at_kill") == 1
                                                  and seen.get("rollout_running_at_kill") is True
                                                  and fleet.bank_version == 2)
    checks["swap_killed_replica_back_on_v2"] = (r1.restart_count == 2
                                                and [r.bank_version for r in fleet.replicas]
                                                == [2, 2])
    checks["swap_v2_answers"] = (all(r["status"] == "ok" and r["bank_version"] == 2
                                     for r in followed) and v2_err <= BF16_SERVE_PROBS_ABS
                                 and [r["anchor"] for r in followed]
                                 == [v2_labels[i] for i in winners])

    # -- 4. tenants and the admission cache ---------------------------------------
    acme_dir = workdir / "tenant_banks" / "acme"
    shutil.copytree(workdir / "banks", acme_dir)
    acme = BankStore(acme_dir)
    acme.set_active("v2")
    tenants = serve_from_archive(archive, device="cuda", tenants=f"acme={acme_dir}", overrides={
        "serving": {"score_impl": "ragged", "replicas": 2, "cache_capacity": 256,
                    "default_deadline_ms": 30000}})
    t_pred = tenants.replicas[0].service.predictor
    acme_bank, _, n_acme = oracle(lambda: t_pred.encode_bank(v2))
    dedup = LoadConfig(pattern="dedup", requests=requests, rps=400.0, seed=7,
                       result_timeout_s=120.0)
    split = _TenantSplit(tenants, "acme")
    before, packs_before = counts(), batches(tenants)
    t_record = run_slo_harness(split, texts, dedup)
    after, t_packs = counts(), batches(tenants) - packs_before
    unique = sorted({t for _, t, _ in split.sent})
    want_default = oracle(lambda: t_pred.score_texts(unique, impl="bucketed"))
    want_acme = oracle(lambda: t_pred.score_texts(unique, acme_bank, n_acme, impl="bucketed"))
    expect = {(None, t): (labels, row) for t, row in zip(unique, want_default)}
    expect.update({("acme", t): (v2_labels, row) for t, row in zip(unique, want_acme)})
    # each replica caches its own answers: a hit is bitwise one of the
    # misses that replica served for the same tenant and text
    misses, tenant_err, hit_equal, hits = collections.defaultdict(list), 0.0, True, 0
    for tenant, text, future in split.sent:
        r = future.result(1.0)
        want_labels, row = expect[(tenant, text)]
        tenant_err = max(tenant_err, float(np.abs(probs(r, want_labels) - row).max()))
        key = (r["replica"], tenant, text)
        payload = {k: r[k] for k in ("predict", "score", "anchor", "bank_version")}
        if r.get("cached"):
            hits += 1
            hit_equal &= payload in misses[key]
        else:
            misses[key].append(payload)
    # a swap of acme (back to the 129-anchor v1) leaves default alone
    default_version = tenants.bank_version
    acme_swap = rolling_swap(tenants, acme.instances("v1"), tenant="acme", store_version="v1")
    fresh = texts[requests - 16:]
    after_swap = [tenants.submit(t).result(120.0) for t in fresh]
    fresh_want = oracle(lambda: t_pred.score_texts(fresh, impl="bucketed"))
    default_err = float(max(np.abs(probs(r, labels) - w).max()
                            for r, w in zip(after_swap, fresh_want)))
    acme_after = tenants.submit(texts[0], tenant="acme").result(120.0)
    out["tenants"] = {
        "requests": requests, "outcomes": t_record["load"]["outcomes"],
        "requests_per_s": t_record["load"]["achieved_rps"], "cache": t_record.get("cache"),
        "packs": t_packs, "launches": {k: after[k] - before[k] for k in after},
        "max_abs_err": tenant_err, "cache_hits_seen": hits,
        "acme_swap_version": acme_swap, "default_after_swap_max_abs_err": default_err,
    }
    checks["tenants_own_banks"] = (t_record["load"]["outcomes"]["ok"] == requests
                                   and tenant_err <= BF16_SERVE_PROBS_ABS)
    checks["tenant_swap_leaves_default"] = (acme_swap == 2 and tenants.bank_version
                                            == default_version == 1
                                            and default_err <= BF16_SERVE_PROBS_ABS
                                            and all(r["bank_version"] == 1 for r in after_swap)
                                            and acme_after["bank_version"] == 2
                                            and len(acme_after["predict"]) == 129)
    checks["cache_hits_bitwise"] = hits > 0 and hit_equal \
        and hits == (t_record.get("cache") or {}).get("hits")
    checks["cache_hits_add_no_pack"] = (after["ragged"] - before["ragged"] == layers * t_packs
                                        and after["anchor_match"] - before["anchor_match"]
                                        == t_packs)

    # -- 5. the front end ------------------------------------------------------------
    servers = [run_http_server(fleet, port=0), run_http_server(tenants, port=0)]
    try:
        base = "http://%s:%d" % servers[0].server_address[:2]
        health = HTTPClient(base).health()
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            metrics = parse_exposition(resp.read().decode("utf-8"))
        with urllib.request.urlopen(base + "/tracez", timeout=30) as resp:
            traces = json.loads(resp.read().decode("utf-8"))["traces"]
        hopped = [t for t in traces if t["hops"] > 0]
        tbase = "http://%s:%d" % servers[1].server_address[:2]
        req = urllib.request.Request(tbase + "/score", method="POST",
                                     data=json.dumps({"text": texts[1]}).encode("utf-8"),
                                     headers={"Content-Type": "application/json",
                                              "X-MemVul-Tenant": "acme"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            acme_http = json.loads(resp.read().decode("utf-8"))
    finally:
        for server in servers:
            server.shutdown()
    out["http"] = {"health_status": health["status"], "replicas": health["replicas"]["total"],
                   "traces": len(traces), "rerouted_traces": len(hopped),
                   "acme_bank_version": acme_http.get("bank_version")}
    checks["http_healthz_both_replicas"] = (health["replicas"]["total"] == 2
                                            and health["replicas"]["healthy"] == 2
                                            and "slo" in health)
    checks["http_metrics_labels"] = (set(metrics.get("serve_served", {})) == {
        '{replica="replica-0"}', '{replica="replica-1"}'} and "router_routed" in metrics)
    checks["http_tracez_rerouted"] = bool(hopped) and all(
        t["trace_id"].startswith("r-") for t in hopped)
    checks["http_tenant_header"] = (acme_http.get("status") == "ok"
                                    and acme_http.get("bank_version") == 2
                                    and len(acme_http.get("predict", {})) == 129)
    fleet.drain()
    tenants.drain()
    out["peak_memory_gib"] = _peak_gib()
    launches = {k: v - oracle_launches[k] for k, v in counts().items()}
    out["launches"] = launches
    del fleet, tenants, arch, pred0, t_pred
    torch.cuda.empty_cache()
    # K2 at the serving bank encode's shape, the fleet's every K2 launch
    out["kernel_flash_bank_shape"] = _flash_at_auto_shapes([(128, 512)], records)
    emit("fleet_path", ok=all(checks.values()), checks=checks, **out, card=nvidia_smi_line())
    if not all(checks.values()):
        raise SystemExit(f"fleet_path failed: {checks}")
    records["ragged_flash_attention"]["launches"] += launches["ragged"]
    records["flash_attention"]["launches"] += launches["flash"]
    records["anchor_match"]["launches"] += launches["anchor_match"]
    return out["closed_loop"]["requests_per_s"]


# the serving hosts of ops_plane_path: the main path's archive served
# "ragged" (packs of 2048 tokens, 16 rows), deadlines long enough that a
# reroute never expires
OPS_HOST_OVERRIDES = {"serving": {"score_impl": "ragged", "default_deadline_ms": 60000}}
# the autoscaler's router: short windows and cooldowns, so a burst scales
# up and a few idle seconds scale down; the latency objective loose, so
# the hint comes from the backlog and the windows alone
OPS_SCALER_OVERRIDES = {"serving": {
    "score_impl": "ragged", "default_deadline_ms": 60000,
    "autoscale_enabled": True, "autoscale_min_replicas": 1, "autoscale_max_replicas": 3,
    "autoscale_interval_s": 0.25, "autoscale_up_consecutive": 1,
    "autoscale_down_consecutive": 2, "autoscale_up_cooldown_s": 1.0,
    "autoscale_down_cooldown_s": 1.0, "autoscale_drain_timeout_s": 10.0,
    "slo_interval_s": 0.25, "slo_fast_window_s": 2.0, "slo_window_s": 4.0,
    "slo_latency_p95_ms": 5000.0}}
# the flight recorder's service: no retries (an injected batch fault
# dead-letters), alerts evaluated every 0.25 s, every alert a bundle; the
# history's resolution is the sampler's cadence, so a one-sample rate spike
# is kept
OPS_RECORDER_OVERRIDES = {
    "serving": {"score_impl": "ragged", "retries": 0, "alert_interval_s": 0.25,
                "incident_min_interval_s": 0.0, "default_deadline_ms": 60000},
    "telemetry": {"tsdb_resolution_s": 0.5}}
OPS_TSDB_CADENCE_S = 0.5
OPS_KERNEL_SYMBOLS = ("ragged_fwd_wgmma_kernel", "anchor_match_kernel")


def _gpu_memory_used_gib() -> float:
    """The card's used memory as nvidia-smi reads it (every process's
    contexts and allocations), in GiB."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) / 1024.0


def _http_json(url: str, data: bytes = None, timeout: float = 30.0):
    """(status, JSON body) of a GET, or of a POST when ``data`` is given."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def phase_ops_plane_path(workdir: Path, records: dict, serve_runs: dict, fleet_rps: float,
                         requests: int = 256,
                         clients: int = 16, kill_at: int = 128, burst_requests: int = 512,
                         burst_rounds: int = 4) -> None:
    """The serving ops plane on the main path's archive, packs of 2048
    tokens and 16 rows.  Four steps:

    1. **hosts**: two ``python -m memvul_tpu_torch serve`` processes on the
       card (:func:`start_process_hosts`, started together) behind a
       ``HostBalancer``; ``requests`` closed-loop requests from ``clients``
       ``loadgen`` clients, host-1's process group SIGKILLed at about the
       ``kill_at``-th: every request answered "ok", none past its deadline,
       within ``BF16_SERVE_PROBS_ABS`` of the bucketed ``score_texts``;
       host-1 restarted and serving; the card's used memory back to where
       it was once the hosts stop.  Then ``serve --hosts`` over the two
       hosts answers over HTTP and merges ``/healthz`` and ``/programz``.
       Each host process's K1, K2 and K3 launches come from its
       ``/programz`` (host-1's first process read just before the kill);
    2. **autoscaler**: a router from one replica with ``autoscale_enabled``
       (min 1, max 3, short cooldowns): open-loop Poisson bursts of
       ``burst_requests`` at 1.5x ``serve_path``'s one-replica ragged rate
       until a scale-up (at most ``burst_rounds``), then idle until the
       fleet is back to one replica; the invariant over live and retired
       replicas;
    3. **flight recorder** at ``tsdb_cadence`` 0.5 s with a run dir: two
       ``serve.batch`` faults that dead-letter fire ``serve_error_rate`` and
       write one bundle; ``/metricsz``, ``/alertz`` and ``/programz``
       answer; ``serve.hbm_in_use_bytes`` > 0; ``program.mfu`` in (0, 1];
    4. **profiler**: ``POST /profilez {"seconds": 2}`` under load until the
       capture ends (a second one answers 409) writes a Chrome trace naming
       the K3 and K1 kernels; a trace with no device activity at all is
       taken again, at most three captures.

    This process's launch counts are set to 0 at the start and read at the
    end, the oracle's taken out; the host processes' are added."""
    import os
    import signal
    import urllib.request

    import numpy as np
    import torch

    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.build import build_reader, serve_from_archive
    from memvul_tpu_torch.config import serving_config
    from memvul_tpu_torch.data.synthetic import corpus_texts
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra
    from memvul_tpu_torch.resilience import faults
    from memvul_tpu_torch.serving import (
        FleetConfig, HostBalancer, HTTPClient, LoadConfig, LoadGenerator, ScoreFuture,
        fleet_snapshot, start_process_hosts)
    from memvul_tpu_torch.serving.fleet import HOST_HEALTHY, _read_banner
    from memvul_tpu_torch.serving.frontend import run_http_server
    from memvul_tpu_torch.telemetry.exposition import parse_exposition
    from memvul_tpu_torch.telemetry.programs import ProgramRegistry

    phase_t0 = time.perf_counter()
    archive = workdir / "model.tar.gz"
    golden = workdir / "CWE_anchor_golden_project.json"
    texts = corpus_texts(json.loads((workdir / "test_project.json").read_text()))[:requests]
    host_log = ROOT / "build" / "ops_plane_hosts.log"
    host_log.parent.mkdir(parents=True, exist_ok=True)
    host_log.write_text("")

    def counts():
        return {"ragged": ra.launches, "flash": fa.launches, "anchor_match": am.launches}

    oracle_launches = collections.Counter()

    def oracle(fn):
        before = counts()
        result = fn()
        oracle_launches.update({k: v - before[k] for k, v in counts().items()})
        return result

    checks, out = {}, {}
    ra.launches = fa.launches = am.launches = 0

    # the oracle: the bucketed path of a predictor shaped as the hosts' is
    arch = load_archive(archive, overrides=OPS_HOST_OVERRIDES, device="cuda")
    serve_cfg = serving_config(arch.config)
    max_length = min(int(serve_cfg["max_length"]), arch.model.config.max_position_embeddings)
    anchors = list(build_reader(arch.config.get("dataset_reader")).read_anchors(str(golden)))
    ref = SiamesePredictor(arch.model, arch.tokenizer, batch_size=int(serve_cfg["max_batch"]),
                           max_length=max_length, score_impl="ragged",
                           token_budget=4 * max_length,
                           max_rows_per_pack=int(serve_cfg["max_batch"]),
                           program_registry=ProgramRegistry())
    oracle(lambda: ref.encode_anchors(anchors))
    labels = list(ref.anchor_labels)
    want = oracle(lambda: ref.score_texts(texts, impl="bucketed"))
    want_by_text = {t: row for t, row in zip(texts, want)}
    torch.cuda.synchronize()

    def probs(r, keys):
        return np.array([r["predict"][a] for a in keys], np.float64)

    # -- 1. two serving processes behind the balancer, one SIGKILLed ------------
    step_t0 = time.perf_counter()
    base_used = _gpu_memory_used_gib()
    used = [base_used]
    sampling = threading.Event()

    def sample_memory():
        while not sampling.wait(0.5):
            used.append(_gpu_memory_used_gib())

    sampler = threading.Thread(target=sample_memory, daemon=True)
    sampler.start()
    argv = [sys.executable, "-m", "memvul_tpu_torch", "serve", str(archive), "--port", "0",
            "--overrides", json.dumps(OPS_HOST_OVERRIDES)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("MEMVUL_FAULTS", None)
    t0 = time.perf_counter()
    hosts = start_process_hosts([argv, argv], startup_timeout_s=300.0, env=env,
                                log_path=str(host_log))
    hosts_start_s = time.perf_counter() - t0
    balancer = HostBalancer(hosts, config=FleetConfig(monitor_interval_s=0.25,
                                                      heartbeat_timeout_s=30.0, max_reroutes=3))
    cli = None
    killed: dict = {}
    fault_free = {}
    try:
        # fault-free closed loops before the kill, each request timed at
        # the client too (a response's latency_ms is the host's own): the
        # two hosts through the balancer (ProcessHost's relay thread and a
        # connection per request), then host-0 alone over HTTP from the
        # clients' own threads, without the balancer and its relay
        def client_timed(submit_fn, wall_ms):
            def timed(text, deadline_ms=None):
                t0 = time.perf_counter()
                future = submit_fn(text, deadline_ms=deadline_ms)
                future.add_done_callback(
                    lambda _r: wall_ms.append((time.perf_counter() - t0) * 1e3))
                return future
            return timed

        direct = HTTPClient(hosts[0].base_url, timeout_s=120.0)

        def direct_submit(text, deadline_ms=None):
            future = ScoreFuture()
            future.resolve(direct.score(text, deadline_ms=deadline_ms))
            return future

        for name, submit_fn in (("balancer_two_hosts", balancer.submit),
                                ("host0_http_direct", direct_submit)):
            wall_ms: list = []
            rep = LoadGenerator(client_timed(submit_fn, wall_ms), LoadConfig(
                pattern="closed", requests=requests, clients=clients, deadline_ms=60000.0,
                result_timeout_s=180.0)).run(texts)
            wall_ms.sort()
            fault_free[name] = {
                "outcomes": rep["outcomes"], "requests_per_s": rep["achieved_rps"],
                "host_latency_ms": rep["latency_ms"],
                "client_latency_ms": {"p50": wall_ms[len(wall_ms) // 2],
                                      "p99": wall_ms[min(len(wall_ms) - 1,
                                                         round(0.99 * (len(wall_ms) - 1)))]},
            }
        lock = threading.Lock()
        sent = []
        submits = iter(range(1, 1 << 30))  # each submit's number, taken under the lock

        def kill_host1():
            killed["launches_before_kill"] = hosts[1].programz().get("kernels", {})
            killed["at"] = time.monotonic()
            os.killpg(hosts[1].proc.pid, signal.SIGKILL)

        def submit(text, deadline_ms=None):
            with lock:
                n = next(submits)
            if n == kill_at:
                threading.Thread(target=kill_host1, daemon=True).start()
            future = balancer.submit(text, deadline_ms=deadline_ms)
            with lock:
                sent.append((text, future))
            return future

        load = LoadConfig(pattern="closed", requests=requests, clients=clients,
                          deadline_ms=60000.0, result_timeout_s=180.0)
        killed_wall_ms: list = []
        report = LoadGenerator(client_timed(submit, killed_wall_ms), load).run(texts)
        killed_wall_ms.sort()
        deadline = time.monotonic() + (300 if "at" in killed else 0)
        while time.monotonic() < deadline and not (
                hosts[1].restart_count == 1 and hosts[1].state == HOST_HEALTHY):
            time.sleep(0.05)
        back_at = time.monotonic()
        responses = [f.result(1.0) for _, f in sent]
        ok = [(t, r) for (t, _), r in zip(sent, responses) if r["status"] == "ok"]
        err = max((float(np.abs(probs(r, labels) - want_by_text[t]).max()) for t, r in ok),
                  default=float("inf"))
        rerouted = [r for r in responses if r.get("host_reroutes")]
        # the restarted host serves again
        after = [balancer.submit(t, deadline_ms=60000.0).result(120.0) for t in texts[:8]]
        counters = balancer._tel.snapshot()["counters"]
        # serve --hosts: a balancer process over the two running hosts
        cli = subprocess.Popen(
            [sys.executable, "-m", "memvul_tpu_torch", "serve", "--hosts",
             ",".join(h.base_url for h in hosts), "--port", "0",
             "--overrides", json.dumps({"serving": {"fleet_monitor_interval_s": 0.5}})],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        banner = _read_banner(cli, 120.0) or {}
        cli_out = {}
        if banner:
            front = HTTPClient(banner["serving"], timeout_s=120.0)
            answers = [front.score(t, deadline_ms=60000.0) for t in texts[:4]]
            health = front.health()
            _, programz = _http_json(banner["serving"] + "/programz")
            cli_out = {
                "hosts": banner.get("hosts"),
                "answers_ok": all(r["status"] == "ok" for r in answers),
                "answers_max_abs_err": max(float(np.abs(probs(r, labels) - want_by_text[t]).max())
                                           for t, r in zip(texts[:4], answers)),
                "healthz_alive": health.get("hosts", {}).get("alive"),
                "programz_hosts": sorted({row.get("host") for row in programz["programs"]}),
            }
        cli.send_signal(signal.SIGTERM)
        cli_rc = cli.wait(60)
        host_launches = {"host-0": hosts[0].programz().get("kernels", {}),
                         "host-1 (restarted)": hosts[1].programz().get("kernels", {}),
                         "host-1 (killed)": killed.get("launches_before_kill", {})}
        host_peak_gib = {}
        for host in hosts:
            with urllib.request.urlopen(host.base_url + "/metrics", timeout=30) as resp:
                parsed = parse_exposition(resp.read().decode("utf-8"))
            host_peak_gib[host.name] = max(
                parsed.get("serve_hbm_peak_bytes", {"": 0.0}).values()) / 2**30
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait(30)
        balancer.drain()
        for host in hosts:
            host.stop(timeout=60.0)
        sampling.set()
        sampler.join(10)
    stopped_used = _gpu_memory_used_gib()
    host_totals = {k: sum(int(h.get(k, 0)) for h in host_launches.values())
                   for k in ("anchor_match", "flash_attention", "ragged_flash_attention")}
    out["hosts"] = {
        "fault_free": fault_free,
        "with_kill": {"outcomes": report["outcomes"], "requests_per_s": report["achieved_rps"],
                      "host_latency_ms": report["latency_ms"],
                      "client_latency_ms": {
                          "p50": killed_wall_ms[len(killed_wall_ms) // 2],
                          "p99": killed_wall_ms[min(len(killed_wall_ms) - 1, round(
                              0.99 * (len(killed_wall_ms) - 1)))]}},
        "rerouted": len(rerouted),
        "start_s": [h.start_seconds for h in hosts], "hosts_start_wall_s": hosts_start_s,
        "recovery_s": back_at - killed["at"] if "at" in killed else None,
        "max_abs_err": err, "tol": BF16_SERVE_PROBS_ABS,
        "fleet_counters": {k: v for k, v in counters.items() if k.startswith("fleet.")},
        "after_restart_hosts": sorted({r.get("host") for r in after}),
        "serve_hosts_cli": cli_out, "serve_hosts_cli_rc": cli_rc,
        "launches": host_launches, "host_allocator_peak_gib": host_peak_gib,
        "gpu_used_gib": {"before": base_used, "peak": max(used), "after_stop": stopped_used},
        "fleet_path_two_replicas_requests_per_s": fleet_rps,
        "wall_s": time.perf_counter() - step_t0,
    }
    checks["hosts_fault_free_all_ok"] = all(
        run["outcomes"]["ok"] == requests for run in fault_free.values()) and len(fault_free) == 2
    checks["hosts_all_ok_none_late"] = (report["outcomes"]["ok"] == requests
                                        and report["outcomes"]["deadline"] == 0
                                        and report["outcomes"]["hang"] == 0)
    checks["hosts_answers"] = len(ok) == requests and err <= BF16_SERVE_PROBS_ABS
    checks["hosts_killed_rerouted_restarted"] = (
        "at" in killed and hosts[1].restart_count == 1 and len(hosts[1].start_seconds) == 2
        and counters.get("fleet.host_deaths") == 1 and counters.get("fleet.host_restarts") == 1
        and len(rerouted) >= 1)
    # the balancer took the fault-free loop, the loop with the kill and ``after``
    checks["hosts_invariant"] = (counters.get("fleet.requests") == 2 * requests + len(after)
                                 == counters.get("fleet.served")
                                 and all(r["status"] == "ok" for r in after)
                                 and "host-1" in out["hosts"]["after_restart_hosts"])
    checks["serve_hosts_cli"] = (cli_out.get("hosts") == 2 and cli_out.get("answers_ok") is True
                                 and cli_out.get("answers_max_abs_err", 1.0) <= BF16_SERVE_PROBS_ABS
                                 and cli_out.get("healthz_alive") == 2
                                 and cli_out.get("programz_hosts") == ["host-0", "host-1"]
                                 and cli_rc == 0)
    checks["hosts_launched_every_kernel"] = all(
        int(h.get(k, 0)) > 0 for h in host_launches.values()
        for k in ("anchor_match", "flash_attention", "ragged_flash_attention"))
    checks["hosts_memory_released"] = stopped_used <= base_used + 1.0

    # -- 2. the autoscaler ---------------------------------------------------------------
    step_t0 = time.perf_counter()
    router = serve_from_archive(archive, device="cuda", overrides=OPS_SCALER_OVERRIDES)
    scaler = router.autoscaler
    trajectory = []
    watching = threading.Event()

    def watch():
        last = None
        while not watching.is_set():
            n = len(router.replicas)
            if n != last:
                trajectory.append((time.monotonic(), n))
                last = n
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    rate = 1.5 * float(serve_runs["ragged"]["requests_per_s"])
    bursts = []
    try:
        reg = router.registry
        for k in range(burst_rounds):
            t_burst = time.monotonic()
            report = LoadGenerator(router.submit, LoadConfig(
                pattern="poisson", requests=burst_requests, rps=rate, seed=k,
                deadline_ms=60000.0, result_timeout_s=180.0)).run(texts)
            bursts.append({"start": t_burst, "end": time.monotonic(),
                           "outcomes": report["outcomes"], "achieved_rps": report["achieved_rps"]})
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and reg.counter("scaler.scale_ups").value == 0:
                time.sleep(0.05)
            if reg.counter("scaler.scale_ups").value:
                break
        idle_from = time.monotonic()
        deadline = idle_from + 90
        while time.monotonic() < deadline and not (
                reg.counter("scaler.scale_ups").value >= 1 and len(router.replicas) == 1
                and not scaler.status()["scaling"]):
            time.sleep(0.05)
        watching.set()
        watcher.join(5)
        members = list(router.replicas) + list(router.retired_replicas)
        snap = fleet_snapshot(members)
        scale_counters = {k: v for k, v in reg.snapshot()["counters"].items()
                          if k.startswith("scaler.")}
        spawned = [r for r in members if r.index > 0]
        shared = all(r.service.predictor.model is members[0].service.predictor.model
                     and r.service.predictor.stream is not None
                     and r.service.predictor.stream != members[0].service.predictor.stream
                     for r in spawned)
    finally:
        watching.set()
        router.drain()
    first_up = next((t for t, n in trajectory if n >= 2), None)
    last_down = next((t for t, n in reversed(trajectory) if n == 1), None)
    out["autoscaler"] = {
        "offered_rps": rate, "bursts": [{k: v for k, v in b.items() if k not in ("start", "end")}
                                        for b in bursts],
        "trajectory": [(round(t - bursts[0]["start"], 3), n) for t, n in trajectory],
        "scale_up_s": first_up - bursts[0]["start"] if first_up else None,
        "scale_down_s": last_down - bursts[-1]["end"] if last_down and first_up else None,
        "counters": scale_counters, "fleet": snap,
        "decisions": len(scaler.history), "wall_s": time.perf_counter() - step_t0,
    }
    checks["autoscaler_scaled_up"] = scale_counters.get("scaler.scale_ups", 0) >= 1 and bool(
        first_up)
    checks["autoscaler_scaled_down_to_one"] = (scale_counters.get("scaler.scale_downs", 0) >= 1
                                               and len(router.replicas) == 1)
    checks["autoscaler_invariant_over_retired"] = snap["invariant_ok"] and len(
        router.retired_replicas) >= 1
    checks["autoscaler_spawn_shares_weights_own_stream"] = bool(spawned) and shared

    # -- 3. the flight recorder, 4. the profiler ----------------------------------------------
    step_t0 = time.perf_counter()
    run_dir = workdir / "ops_run"
    service = serve_from_archive(archive, out_dir=run_dir, device="cuda",
                                 overrides=OPS_RECORDER_OVERRIDES, tsdb_cadence=OPS_TSDB_CADENCE_S)
    server = run_http_server(service, port=0, profile_dir=run_dir / "profiles")
    base = "http://%s:%d" % server.server_address[:2]
    recorder = service.incident_recorder
    try:
        warm = LoadGenerator(service.submit, LoadConfig(
            pattern="closed", requests=64, clients=clients, result_timeout_s=120.0)).run(texts)
        # the first dead letter creates serve.errors; the second, a sample
        # later, is its first rate
        errors = []
        for k, text in enumerate(texts[:2]):
            if k:
                time.sleep(2 * OPS_TSDB_CADENCE_S)
            faults.configure("serve.batch=raise:RuntimeError:injected dead letter")
            errors.append(service.submit(text).result(120.0)["status"])
            fault_at = time.monotonic()
        faults.reset()
        deadline = time.monotonic() + 60
        bundle = []
        while time.monotonic() < deadline and not bundle:
            if recorder.incidents_dir.is_dir():
                bundle = [p for p in recorder.incidents_dir.iterdir()
                          if p.name.endswith("alert-serve_error_rate")]
            time.sleep(0.02)
        # from the second dead letter to its bundle on disk
        bundle_s = time.monotonic() - fault_at if bundle else None
        bundle_files = sorted(p.name for p in bundle[0].iterdir()) if bundle else []
        m_status, metricsz = _http_json(base + "/metricsz?metric=serve.&window=300")
        a_status, alertz = _http_json(base + "/alertz")
        p_status, programz = _http_json(base + "/programz")
        gauges = service.registry.snapshot()["gauges"]
        part = next((p for _, p in service.metrics_snapshots()[1:]
                     if "program.programs" in p.get("counters", {})), {})
        mfu = part.get("gauges", {}).get("program.mfu")
        rows = {row["key"]: row for row in service.programs_snapshot()}
        pack_mfu = rows.get("ragged:1x2048", {}).get("mfu")
        # 4. the profiler, under load until the capture has ended; a trace
        # that caught no device activity at all is taken again (at most
        # three captures), as _kernel_breakdown retakes an empty profile
        captures = []
        for _ in range(3):
            profile_t0 = time.monotonic()
            first = _http_json(base + "/profilez", json.dumps({"seconds": 2}).encode())
            second = _http_json(base + "/profilez", json.dumps({"seconds": 2}).encode())
            loaded = 0
            while time.monotonic() - profile_t0 < 60 and (loaded == 0 or server.profiler.busy):
                LoadGenerator(service.submit, LoadConfig(pattern="closed", requests=64,
                                                         clients=clients,
                                                         result_timeout_s=120.0)).run(texts)
                loaded += 64
            trace = Path(first[1].get("trace_dir", run_dir / "missing")) / "trace.json"
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and (server.profiler.busy or not trace.exists()):
                time.sleep(0.1)
            names, kernel_events = set(), 0
            if trace.exists():
                for event in json.loads(trace.read_text()).get("traceEvents", []):
                    if event.get("cat") != "kernel":
                        continue
                    kernel_events += 1
                    names.update(sym for sym in OPS_KERNEL_SYMBOLS if sym in event.get("name", ""))
            trace_mb = trace.stat().st_size / 2**20 if trace.exists() else None
            captures.append({"status": first[0], "second_status": second[0],
                             "requests_under_load": loaded, "kernel_events": kernel_events,
                             "kernels_named": sorted(names), "trace_mb": trace_mb})
            if first[0] != 200 or kernel_events:
                break
    finally:
        faults.reset()
        server.shutdown()
        service.drain()
    out["flight_recorder"] = {
        "tsdb_cadence_s": OPS_TSDB_CADENCE_S, "warm_outcomes": warm["outcomes"],
        "dead_letters": errors, "bundle": bundle[0].name if bundle else None,
        "bundle_files": bundle_files, "bundle_s": bundle_s,
        "metricsz": {"status": m_status, "enabled": metricsz.get("enabled"),
                     "series": metricsz.get("series")},
        "alertz": {"status": a_status, "firing": sorted(f["rule"] for f in alertz.get(
            "firing", []))},
        "programz": {"status": p_status, "count": programz.get("count"),
                     "kernels": programz.get("kernels")},
        "hbm_in_use_gib": gauges.get("serve.hbm_in_use_bytes", 0.0) / 2**30,
        "hbm_peak_gib": gauges.get("serve.hbm_peak_bytes", 0.0) / 2**30,
        "program_mfu": mfu, "pack_program_mfu": pack_mfu,
        "pack_program": {k: rows.get("ragged:1x2048", {}).get(k)
                         for k in ("invocations", "device_time_s", "flops", "compile_s")},
    }
    out["profiler"] = {"first": first, "captures": captures,
                       "wall_s": time.perf_counter() - step_t0}
    checks["recorder_bundle"] = (errors == ["error", "error"] and len(bundle) == 1
                                 and bundle_files == sorted(["manifest.json", "metrics.json",
                                                             "traces.json", "programs.json"]))
    checks["recorder_endpoints"] = (m_status == 200 and metricsz.get("enabled") is True
                                    and bool(metricsz.get("history"))
                                    and a_status == 200
                                    and "serve_error_rate" in out["flight_recorder"]["alertz"][
                                        "firing"]
                                    and p_status == 200 and programz.get("count", 0) > 0)
    checks["recorder_hbm_gauge"] = gauges.get("serve.hbm_in_use_bytes", 0.0) > 0
    checks["recorder_mfu_in_0_1"] = (mfu is not None and 0.0 < mfu <= 1.0
                                     and pack_mfu is not None and 0.0 < pack_mfu <= 1.0)
    checks["profiler_capture"] = (all(c["status"] == 200 and c["second_status"] == 409
                                      for c in captures)
                                  and names == set(OPS_KERNEL_SYMBOLS))

    out["peak_memory_gib"] = _peak_gib()
    launches = {k: v - oracle_launches[k] for k, v in counts().items()}
    out["launches"] = {"this_process": launches, "hosts": host_totals}
    del ref, arch, router, service
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - phase_t0
    emit("ops_plane_path", ok=all(checks.values()), checks=checks, **out, card=nvidia_smi_line())
    if not all(checks.values()):
        sys.stderr.write(host_log.read_text()[-6000:])
        raise SystemExit(f"ops_plane_path failed: {checks}")
    records["ragged_flash_attention"]["launches"] += (launches["ragged"]
                                                      + host_totals["ragged_flash_attention"])
    records["flash_attention"]["launches"] += launches["flash"] + host_totals["flash_attention"]
    records["anchor_match"]["launches"] += launches["anchor_match"] + host_totals["anchor_match"]


def phase_selfcheck(workdir: Path) -> None:
    """``python -m memvul_tpu_torch selfcheck`` on the card, as a user runs
    it: a synthetic workspace, a tiny train, the archive, ``evaluate``."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "memvul_tpu_torch", "selfcheck", "--dir", str(workdir / "sc")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if lines else {}
    ok = proc.returncode == 0 and report.get("selfcheck") == "ok" and report.get("device") == "cuda"
    emit("selfcheck", ok=ok, wall_s=wall, report=report, card=nvidia_smi_line())
    if not ok:
        raise SystemExit(f"selfcheck failed ({proc.returncode}): {proc.stderr[-2000:]}")


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
    phase_flash_grad()
    phase_ragged(records)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        phase_main_path(Path(tmp), records)
        serve_runs = phase_serve_path(Path(tmp), records)
        emit_anchor_shapes(records)
        # the evaluate paths of the reference's override files, the int8
        # tier, restartable scoring and the cascade (their launches add to
        # the kernels' counts after the per-shape checks above)
        bf16_auto = phase_main_path_auto(Path(tmp), records)
        phase_main_path_int8(Path(tmp), records, bf16_auto)
        phase_int8_linear()
        phase_evaluate_resume(Path(tmp), records)
        phase_serve_cascade(Path(tmp), records)
        phase_serve_identity(Path(tmp))
        phase_profile(Path(tmp) / "model.tar.gz")
        phase_train_path(Path(tmp), records)
        # the paper's other trained models: further pretraining, MemVul-m, TextCNN
        other = _other_workspace(Path(tmp))
        phase_pretrain_path(Path(tmp), other, records)
        phase_single_path(Path(tmp), other, records)
        phase_cnn_path(Path(tmp), other, records)
        # slice 8: sharded scoring on the card, the bank lifecycle, selfcheck
        corpus_result = phase_score_corpus_path(Path(tmp), records)
        phase_bank_path(Path(tmp), records, corpus_result)
        phase_selfcheck(Path(tmp))
        # slice 9: the serving plane's fleet on one card
        fleet_rps = phase_fleet_path(Path(tmp), records, serve_runs)
        # the ops plane: serving processes, autoscaler, flight recorder, profiler
        phase_ops_plane_path(Path(tmp), records, serve_runs, fleet_rps)
    phase_main_path_reference()
    phase_ragged_reference()
    phase_train_reference()
    phase_pretrain_reference()

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
