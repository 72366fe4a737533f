"""Benchmark harness of the port (the JAX package's ``bench.py``): Siamese
anchor-bank scoring throughput on the card, and the microbenches.

    python -m memvul_tpu_torch bench
    python -m memvul_tpu_torch.bench
    BENCH_DEVICE=cpu BENCH_MODEL=tiny BENCH_REPORTS=64 python -m memvul_tpu_torch bench

The main pass streams synthetic issue reports through the full inference
path — BERT-base encode (bf16), the match against a 129-anchor bank, the
per-anchor softmax and best-anchor reduce — which is what
``evaluate_from_archive`` does over a corpus.  It prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", ...}``.

Baseline (the denominator).  ``BASELINE_RPS_512`` = 190 reports/s is the
JAX package's *estimate* for the reference on a GTX 3090 — about 71
TFLOP/s dense fp16 peak at an assumed 30% MFU, one report at length 512
costing about 2·110e6·512 FLOPs.  It is not a measurement of anything;
the record keeps it as its denominator (``vs_baseline``, and
``vs_baseline_band`` over 20-40% MFU) so records of both packages read
alike.

Env knobs (the JAX package's, with their defaults): BENCH_SEQ_LEN (cap,
512), BENCH_BUCKETS ("auto": padding-minimising boundaries from a corpus
sample, BENCH_BUCKET_COUNT of them, 8; a comma list pins them; empty
pads to the cap), BENCH_TOKENS (token budget per batch, 262144),
BENCH_REPORTS (32768), BENCH_ATTENTION (xla | flash: the plain attention
or the flash kernel), BENCH_QUANT (int8_dynamic: the int8 tier),
BENCH_MODEL (base | tiny — tiny is plumbing validation only),
BENCH_INFLIGHT (batches launched ahead of the host sync, 2),
BENCH_PROFILE (dir: a ``torch.profiler`` trace of the timed pass),
BENCH_DEVICE (cuda | cpu, default cuda: the CPU only when asked),
BENCH_MICRO (anchor_match: the bank match alone, the anchor-match kernel
against the plain PyTorch decomposition, BENCH_MICRO_{B,A,D,ITERS};
serve: the online scoring service under closed-loop clients,
BENCH_MICRO_REQUESTS / BENCH_MICRO_CLIENTS, BENCH_SERVE_MAX_BATCH /
BENCH_SERVE_WAIT_MS, BENCH_SERVE_IMPL bucketed | ragged | continuous |
cascade | ab (all four over one seeded schedule), BENCH_CASCADE_BAND,
BENCH_SERVE_CACHE=1 (+ _CAPACITY, _UNIQUE), BENCH_SERVE_TOKEN_BUDGET,
BENCH_SERVE_TRACE_RATE, BENCH_SERVE_TSDB_CADENCE, BENCH_SERVE_REPLICAS
(a router over N replicas, BENCH_SERVE_PATTERN / _RPS / _PERIOD_S),
BENCH_SERVE_AUTOSCALE=1; train_step: pad-to-max against bucketed+dedup
collation over one seeded pair stream, BENCH_TRAIN_{STEPS,BATCH,ACCUM,
REPORTS}; corpus: sharded corpus scoring, BENCH_CORPUS_{SHARDS,REPORTS};
tune: the autotuner in-process, BENCH_TUNE=1 is an alias,
BENCH_TUNE_{MODE,CASCADE,OUT}), BENCH_PHASE_TIMEOUT (per-phase watchdog
deadline inside the child, 600 s, 0 disables), BENCH_TELEMETRY_DIR (the
child's run dir: phase spans in events.jsonl, HEARTBEAT.json,
telemetry.json with the kernels' launch counts ``kernels.launches.*``
and the batches that explain them, ``bench.*``), BENCH_LINT=1 (the
supervisor first prints one ``{"metric": "lint"}`` record of the
static-analysis engine over the port's tree, then runs the bench).  BENCH_MICRO_INTERPRET has no
meaning without Pallas interpret mode and is refused.

Supervision.  ``main`` first waits for the device with cheap probe
children (a tiny matmul on the card and a ``torch.cuda.synchronize()``
under BENCH_PROBE_TIMEOUT, 240 s, for BENCH_DEVICE_WAIT total seconds,
1800; 0 disables), then runs the measurement in a child process
(``python -m memvul_tpu_torch.bench``) with a hard per-attempt deadline,
and retries transient failures with backoff (BENCH_ATTEMPTS, 3;
BENCH_ATTEMPT_TIMEOUT, 1500 s; BENCH_BACKOFF, 20 s).  The supervisor
itself never touches CUDA.  On unrecoverable failure it still prints
exactly one JSON line with an ``error`` field and exits 1, and kills the
child's whole process group so nothing is left holding the card.  A probe
that finds no CUDA device at all fails at once: that does not recover.
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

from memvul_tpu_torch.resilience.retry import RetryPolicy

# the JAX package's estimate for the reference on a GTX 3090 at 30% MFU
# (module docstring): the record's denominator, not a measurement
BASELINE_RPS_512 = 190.0

_CHILD_ENV_FLAG = "MEMVUL_BENCH_CHILD"

# the kernels whose launch counts a child's telemetry.json carries
KERNEL_MODULES = ("anchor_match", "flash_attention", "ragged_attention", "plain_attention",
                  "grouped_gemm")


def _metric_name() -> str:
    micro = os.environ.get("BENCH_MICRO")
    if not micro and os.environ.get("BENCH_TUNE") == "1":
        micro = "tune"  # BENCH_TUNE=1 alias for BENCH_MICRO=tune
    return f"{micro}_microbench" if micro else "siamese_scoring_throughput"


def _device():
    """The child's device: BENCH_DEVICE (default ``cuda``; a host without
    CUDA raises unless the CPU is asked for)."""
    from memvul_tpu_torch.utils.platform import resolve_device

    return resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))


def _sync(device) -> None:
    """End a timed region: the card's queue drained (PyTorch returns before
    the device finishes)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program_blocks() -> dict:
    """Per-program rows + the roofline summary for a bench record
    (``telemetry/programs.py``; the JAX package's ``xla`` block, read from
    the port's registry: analytic costs, CUDA-event device time).  On the
    CPU the rows carry costs with ``interpret_only`` set, so a CPU run and
    a card run emit the same record shape.  Empty when the bench path
    registered nothing."""
    from memvul_tpu_torch.telemetry.programs import get_program_registry

    registry = get_program_registry()
    programs = registry.snapshot()
    if not programs:
        return {}
    roof = registry.roofline()
    return {
        "programs": [
            {
                "key": p["key"],
                "scope": p["scope"],
                "compile_s": p["compile_s"],
                "flops": p["flops"],
                "bytes_accessed": p["bytes_accessed"],
                "hbm_bytes": p["hbm_bytes"],
                "invocations": p["invocations"],
                "device_time_s": p["device_time_s"],
                "mfu": p["busy_util"],  # the JAX package's record key
            }
            for p in programs
        ],
        "xla": {
            "device_kind": roof["device_kind"],
            "interpret_only": roof["interpret_only"],
            "mfu": roof["busy_util"],  # (the record's key, as above)
            "membw_util": roof["membw_util"],
            "flops_total": roof["flops_total"],
            "device_time_s": roof["device_time_s"],
        },
    }


class _PhaseWatchdog:
    """Hard per-phase deadline inside the bench child.

    A wedged device hangs one call for the whole attempt budget, and the
    only evidence would be the supervisor's kill.  This watchdog runs on a
    daemon thread, so when a phase (workspace build, anchor encode,
    warmup, the timed pass) exceeds its deadline it still emits a parseable
    JSON failure record naming the stuck phase and hard-exits 124 — even
    while the main thread is blocked inside a CUDA synchronize that will
    never return.  ``os._exit`` (not sys.exit) is deliberate: a wedged
    CUDA context may hang interpreter teardown too.

    The record carries ``"error"``/``"watchdog_timeout"`` so the
    supervisor's result extraction skips it and retries the attempt (the
    marker is in ``resilience.retry.RETRYABLE_MARKERS``).
    """

    def __init__(self, timeout: float, metric: str):
        self.timeout = timeout
        self.metric = metric

    @contextlib.contextmanager
    def phase(self, name: str):
        # every phase is a telemetry span: the liveness phase and progress
        # clock move even without a run dir, and with BENCH_TELEMETRY_DIR
        # the spans land in events.jsonl for telemetry-report
        from memvul_tpu_torch.telemetry import get_registry

        if self.timeout <= 0:  # BENCH_PHASE_TIMEOUT=0 disables
            with get_registry().span(f"bench.{name}"):
                yield
            return
        timer = threading.Timer(self.timeout, self._expire, args=(name,))
        timer.daemon = True
        timer.start()
        try:
            with get_registry().span(f"bench.{name}"):
                yield
        finally:
            timer.cancel()

    def _expire(self, name: str) -> None:
        from memvul_tpu_torch.telemetry import get_registry

        # last-heartbeat age separates "stuck phase" (age ≈ the whole
        # phase timeout: nothing progressed since the phase opened) from
        # "slow device" (small age: batches were still completing when the
        # deadline hit)
        age = get_registry().heartbeat_age_s()
        record = {
            "metric": self.metric,
            "value": 0.0,
            "unit": "reports/sec",
            "vs_baseline": 0.0,
            "error": f"watchdog: phase {name!r} exceeded {self.timeout:.0f}s",
            "phase": name,
            "watchdog_timeout": True,
            "heartbeat_age_s": round(age, 1),
        }
        # program-registry attribution: a recent build with a small age
        # means the phase is wedged in (or right after) that program's
        # first call; no program at all means the hang predates the first
        try:
            from memvul_tpu_torch.telemetry.programs import get_program_registry

            last = get_program_registry().last_compile()
            if last is not None:
                record["last_compile_key"] = last["key"]
                record["last_compile_age_s"] = round(last["age_s"], 1)
        except Exception:  # the failure record must always emit
            pass
        sys.stdout.write(json.dumps(record) + "\n")
        sys.stdout.flush()
        sys.stderr.write(
            f"bench watchdog: phase {name!r} exceeded {self.timeout:.0f}s; "
            "aborting attempt\n"
        )
        sys.stderr.flush()
        os._exit(124)


def _watchdog() -> _PhaseWatchdog:
    return _PhaseWatchdog(
        float(os.environ.get("BENCH_PHASE_TIMEOUT", "600")), _metric_name()
    )


def bench_model(vocab_size: int, model_size: str, seq_len: int, **replace):
    """(``MemoryModel`` with weights drawn from seed 0, f32 on the CPU, and
    the effective ``seq_len``): ``"tiny"`` is the 2-layer test geometry
    (``seq_len`` clamped to its positions), ``"base"`` BERT-base in bf16 at
    a vocabulary of at least 30522, its position table extended to
    ``seq_len`` when that is longer.  ``replace`` sets other
    ``BertConfig`` fields (``attention_impl``, ``quant``)."""
    import torch

    from memvul_tpu_torch.build import init_params
    from memvul_tpu_torch.models.bert import BertConfig
    from memvul_tpu_torch.models.memory import MemoryModel

    if model_size == "tiny":
        cfg = BertConfig.tiny(vocab_size=vocab_size)
        seq_len = min(int(seq_len), cfg.max_position_embeddings)
    else:
        cfg = BertConfig.base(vocab_size=max(30522, vocab_size), dtype=torch.bfloat16)
        if int(seq_len) > cfg.max_position_embeddings:
            cfg = cfg.replace(max_position_embeddings=int(seq_len))
    if replace:
        cfg = cfg.replace(**replace)
    return init_params(MemoryModel(cfg), seed=0), int(seq_len)


def step_shapes(trainer) -> "collections.Counter":
    """The ``(sample1, sample2)`` ``[K, B, L]`` stack shapes one epoch of
    ``trainer`` steps on, each with its stack count: the JAX trainer's
    compiled step programs (``train_trace_count``).  Replays the epoch's
    first ``steps_per_epoch`` stacks from the same seeded stream, outside
    any timed region (the emission order is a pure function of the
    stream)."""
    import collections
    import itertools

    stacks = trainer._microbatch_stacks()
    try:
        return collections.Counter(
            tuple(stack[side]["input_ids"].shape for side in ("sample1", "sample2"))
            for stack, _info in itertools.islice(stacks, trainer.config.steps_per_epoch)
        )
    finally:
        stacks.close()


def book_step_programs(shapes, model, epochs: int) -> None:
    """A ``train_step:<K>x<B>x<L1>,<K>x<B>x<L2>`` row (the JAX trainer's
    key) in the process's ``ProgramRegistry`` for each stack shape of
    :func:`step_shapes`, registered once per process with no compile time
    (eager PyTorch builds nothing per shape) and an analytic count
    (forward and backward: three forwards over every token slot,
    attention at the padded lengths); one invocation per stack stepped in
    ``epochs`` epochs over the stream."""
    from memvul_tpu_torch.telemetry.programs import (
        get_program_registry, model_bytes, score_cost,
    )

    registry = get_program_registry()
    for shape, stacks in shapes.items():
        key = "train_step:" + ",".join("x".join(str(int(d)) for d in side) for side in shape)
        if key not in registry:
            lengths = [side[-1] for side in shape for _ in range(side[0] * side[1])]
            flops, nbytes = score_cost(model.config, sum(lengths), lengths, len(lengths),
                                       weight_bytes=model_bytes(model))
            registry.register(key, scope="train", flops=3.0 * flops,
                              bytes_accessed=3.0 * nbytes, device=next(model.parameters()).device)
        for _ in range(stacks * epochs):
            registry.record_invocation(key)


def _anchor_instances(ws, n_anchors: int) -> list:
    """``n_anchors`` bank entries cycled from the workspace's anchor texts."""
    base = list(ws["anchors"].items())
    return [
        {"text1": base[i % len(base)][1],
         "meta": {"label": f"{base[i % len(base)][0]}#{i}", "type": "golden"}}
        for i in range(n_anchors)
    ]


def _run_bench() -> None:
    micro = os.environ.get("BENCH_MICRO")
    if micro == "anchor_match":
        _run_anchor_match_micro()
        return
    if micro == "serve":
        _run_serve_micro()
        return
    if micro == "train_step":
        _run_train_step_micro()
        return
    if micro == "corpus":
        _run_corpus_micro()
        return
    if micro == "tune" or (not micro and os.environ.get("BENCH_TUNE") == "1"):
        _run_tune_micro()
        return
    if micro:
        raise ValueError(
            f"unknown BENCH_MICRO mode {micro!r} "
            "(known: anchor_match, corpus, serve, train_step, tune)"
        )
    from memvul_tpu_torch.build import _auto_buckets_for_corpus
    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.telemetry import get_registry
    from memvul_tpu_torch.utils.profiling import trace_context

    watchdog = _watchdog()
    device = _device()
    tel = get_registry()

    seq_len = int(os.environ.get("BENCH_SEQ_LEN", "512"))
    buckets_env = os.environ.get("BENCH_BUCKETS", "auto")
    auto_bucket_mode = buckets_env == "auto"
    if auto_bucket_mode:
        buckets = None  # derived from a corpus length sample below
    else:
        buckets = (
            tuple(int(b) for b in buckets_env.split(",") if b) if buckets_env else None
        )
        if buckets:
            buckets = tuple(b for b in buckets if b <= seq_len) or (seq_len,)
    tokens_per_batch = int(os.environ.get("BENCH_TOKENS", str(256 * 1024)))
    n_reports = int(os.environ.get("BENCH_REPORTS", "32768"))
    n_anchors = 129  # the reference's external-memory size

    with watchdog.phase("workspace"):
        ws = build_workspace(
            tempfile.mkdtemp(),
            seed=0,
            num_projects=8,
            reports_per_project=max(4, n_reports // 8),
            realistic_lengths=True,
        )
    attn = os.environ.get("BENCH_ATTENTION", "xla")
    quant = os.environ.get("BENCH_QUANT")
    replace = {}
    if attn != "xla":
        replace["attention_impl"] = attn
    if quant:
        replace["quant"] = quant
    requested = seq_len
    model, seq_len = bench_model(ws["tokenizer"].vocab_size,
                                 os.environ.get("BENCH_MODEL", "base"), seq_len, **replace)
    if seq_len != requested:
        if buckets:
            buckets = tuple(b for b in buckets if b <= seq_len) or (seq_len,)
        print(f"tiny geometry: clamped BENCH_SEQ_LEN to {seq_len}", file=sys.stderr)
    # the first device op: where a wedged device hangs
    with watchdog.phase("model_init"):
        model = model.to(device).eval()
        _sync(device)

    reader = MemoryReader(
        cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"]
    )
    test_instances = list(reader.read(ws["paths"]["test"], split="test"))
    while len(test_instances) < n_reports:
        test_instances = test_instances + test_instances
    test_instances = test_instances[:n_reports]

    if auto_bucket_mode:
        # the evaluation config's "auto" recipe, so bench and evaluate
        # measure one bucketing policy
        n_buckets = int(os.environ.get("BENCH_BUCKET_COUNT", "8"))
        buckets = _auto_buckets_for_corpus(
            reader, ws["tokenizer"], ws["paths"]["test"], seq_len, n_buckets=n_buckets,
        )
        print(f"auto buckets: {buckets}", file=sys.stderr)

    predictor = SiamesePredictor(
        model,
        ws["tokenizer"],
        batch_size=tokens_per_batch // seq_len,
        max_length=seq_len,
        buckets=buckets,
        tokens_per_batch=tokens_per_batch if buckets else None,
        telemetry=tel,
    )
    # the bank, then every stream shape once (the kernel library builds
    # and each kernel launches here, not at a first mid-stream batch)
    with watchdog.phase("anchor_encode"):
        predictor.encode_anchors(_anchor_instances(ws, n_anchors))
        warm = predictor.warmup_compile()
        _sync(device)
    tel.counter("bench.anchor_chunks").inc(int(predictor.stats["anchor_chunks"]))
    tel.counter("bench.warmup_shapes").inc(int(warm))

    inflight = int(os.environ.get("BENCH_INFLIGHT", "2"))

    def run_pass():
        total = 0
        start = time.perf_counter()
        for _probs, metas in predictor.score_instances(
            iter(test_instances), inflight=inflight
        ):
            total += len(metas)
        _sync(device)
        return total, time.perf_counter() - start

    with watchdog.phase("warmup_pass"):
        run_pass()  # the tokenizer cache and any shape the warmup missed
    with watchdog.phase("timed_pass"):
        with trace_context(os.environ.get("BENCH_PROFILE")):
            total, elapsed = run_pass()
    rps = total / elapsed

    # the baseline estimate is FLOP-derived at padded length 512; scale
    # only when the cap itself is overridden
    baseline = BASELINE_RPS_512 * (512.0 / seq_len)
    point = rps / baseline
    lo = point * (0.30 / 0.40)  # the baseline at 40% MFU
    hi = point * (0.30 / 0.20)  # the baseline at 20% MFU
    print(
        json.dumps(
            {
                "metric": "siamese_scoring_throughput",
                "value": round(rps, 1),
                "unit": "reports/sec",
                "vs_baseline": round(rps / baseline, 2),
                "vs_baseline_band": [round(lo, 2), round(hi, 2)],
                "config": {
                    "model": os.environ.get("BENCH_MODEL", "base"),
                    "seq_len": seq_len,
                    "buckets": list(buckets) if buckets else None,
                    "tokens_per_batch": tokens_per_batch,
                    "reports": n_reports,
                    "attention": attn,
                    "quant": quant,
                    "inflight": inflight,
                },
                **_program_blocks(),
            }
        )
    )


def _device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: its kernels' own time summed by
    ``torch.profiler`` over ``iters`` calls, without the launch gaps (a
    small kernel's wall per call times the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        # kernels only: an operator's or annotation's row repeats its kernels
        if us and not getattr(evt, "is_user_annotation", False) \
                and not evt.key.startswith(("aten::", "cuda", "ProfilerStep")):
            total_us += us
    return total_us / 1e3 / iters


def _run_anchor_match_micro() -> None:
    """BENCH_MICRO=anchor_match: the bank-match op in isolation.

    Times the anchor-match kernel against the decomposed PyTorch einsum
    (the plain version) at the production shape (B=512 reports × A=129
    anchors × D=512, bf16 on the card; BENCH_MICRO_{B,A,D,ITERS}) and
    prints one JSON line with both variants and the analytic memory
    traffic the kernel exists to remove.  On the card the "fused" variant
    is the kernel (``fused_backend: "cuda"``) and never falls back; a CPU
    run (BENCH_DEVICE=cpu) times the plain version under both names
    (``fused_backend: "plain"``).  K1's wall per call at B=512 is mostly
    the host's launch cost, so on the card the record adds each variant's
    profiler device time (``*_device_ms``)."""
    if os.environ.get("BENCH_MICRO_INTERPRET"):
        raise SystemExit(
            "BENCH_MICRO_INTERPRET: the port has no interpret mode (it is Pallas's); "
            "on the card the kernel runs, on the CPU (BENCH_DEVICE=cpu) the plain version"
        )
    import numpy as np
    import torch

    from memvul_tpu_torch.ops.anchor_match import anchor_match, anchor_match_reference
    from memvul_tpu_torch.utils.platform import is_cuda_device

    watchdog = _watchdog()
    device = _device()
    b = int(os.environ.get("BENCH_MICRO_B", "512"))
    a = int(os.environ.get("BENCH_MICRO_A", "129"))
    d = int(os.environ.get("BENCH_MICRO_D", "512"))
    iters = int(os.environ.get("BENCH_MICRO_ITERS", "50"))
    c = 2
    on_card = is_cuda_device(device)

    with watchdog.phase("micro_setup"):
        dtype = torch.bfloat16 if on_card else torch.float32
        rng = np.random.default_rng(0)
        u = torch.as_tensor(rng.normal(size=(b, d)), dtype=dtype).to(device)
        v = torch.as_tensor(rng.normal(size=(a, d)), dtype=dtype).to(device)
        k = torch.as_tensor(rng.normal(size=(3 * d, c)) * 0.1, dtype=dtype).to(device)
    fused_backend = "cuda" if on_card else "plain"

    def fused():
        return anchor_match(u, v, k)

    def decomposed():
        return anchor_match_reference(u, v, k)

    def rep(fn):
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        return (time.perf_counter() - start) / iters

    # build and warm BOTH variants before timing either, then interleave
    # the timed reps and keep each variant's best
    with watchdog.phase("micro_compile"):
        for fn in (decomposed, fused):
            fn()
        _sync(device)
    with watchdog.phase("micro_timing"):
        xla_s, fused_s = float("inf"), float("inf")
        for _ in range(3):
            xla_s = min(xla_s, rep(decomposed))
            fused_s = min(fused_s, rep(fused))
    device_ms = {}
    if on_card:
        with watchdog.phase("micro_device_time"):
            device_ms = {"fused_device_ms": round(_device_ms(fused, iters), 5),
                         "decomposed_device_ms": round(_device_ms(decomposed, iters), 5)}

    # analytic memory traffic: the decomposed path writes the [B, A, D]
    # abs-diff then reads it back for the einsum; the fused path touches
    # the inputs once and the [B, A, C] logits once
    sz = torch.finfo(dtype).bits // 8
    io_bytes = (b * d + a * d + 3 * d * c) * sz + b * a * c * sz
    bytes_decomposed = io_bytes + 2 * b * a * d * sz
    print(
        json.dumps(
            {
                "metric": "anchor_match_microbench",
                "value": round(xla_s / fused_s, 3),
                "unit": "x (decomposed_ms / fused_ms)",
                "fused_ms": round(fused_s * 1e3, 4),
                "decomposed_ms": round(xla_s * 1e3, 4),
                **device_ms,
                "matches_per_s_fused": round(b * a / fused_s),
                "matches_per_s_decomposed": round(b * a / xla_s),
                "hbm_bytes_est": {
                    "decomposed": bytes_decomposed,
                    "fused": io_bytes,
                    "ratio": round(bytes_decomposed / io_bytes, 1),
                },
                "config": {
                    "B": b, "A": a, "D": d, "iters": iters,
                    "dtype": str(dtype).replace("torch.", ""),
                    "fused_backend": fused_backend,
                },
            }
        )
    )


def _run_train_step_micro() -> None:
    """BENCH_MICRO=train_step: Siamese train-step throughput, pad-to-max
    against bucketed+dedup collation.

    Runs the SAME epoch pair stream (identical reader seed → identical
    pairs) through two ``MemoryTrainer``s from the same seeded weights that
    differ only in collation: ``train_buckets=None`` (pad-to-max) against
    the default bucket grid with in-batch anchor deduplication.  Each path
    gets one warmup epoch and one timed epoch over the same stream; the
    record reports wall-clock plus BOTH token throughputs per path.

    Knobs: BENCH_TRAIN_STEPS (optimizer steps per epoch, 16),
    BENCH_TRAIN_BATCH (32), BENCH_TRAIN_ACCUM (2), BENCH_TRAIN_REPORTS
    (workspace reports per project, 256), BENCH_SEQ_LEN (512),
    BENCH_MODEL (base | tiny).
    """
    import copy

    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.training.trainer import MemoryTrainer, TrainerConfig

    watchdog = _watchdog()
    device = _device()
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "16"))
    batch = int(os.environ.get("BENCH_TRAIN_BATCH", "32"))
    accum = int(os.environ.get("BENCH_TRAIN_ACCUM", "2"))
    seq_len = int(os.environ.get("BENCH_SEQ_LEN", "512"))
    per_project = int(os.environ.get("BENCH_TRAIN_REPORTS", "256"))

    with watchdog.phase("workspace"):
        ws = build_workspace(
            tempfile.mkdtemp(), seed=0, num_projects=8,
            reports_per_project=per_project, realistic_lengths=True,
        )
    with watchdog.phase("model_init"):
        model, seq_len = bench_model(ws["tokenizer"].vocab_size,
                                     os.environ.get("BENCH_MODEL", "base"), seq_len)

    def run_path(name: str, **cfg_kw):
        reader = MemoryReader(
            cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"],
            sample_neg=0.5, seed=2021,
        )
        trainer = MemoryTrainer(
            # each path trains its own copy of the seeded weights
            copy.deepcopy(model), ws["tokenizer"], reader,
            train_path=ws["paths"]["train"],
            config=TrainerConfig(
                batch_size=batch, grad_accum=accum, max_length=seq_len,
                steps_per_epoch=steps, num_epochs=1, warmup_steps=1,
                serialization_dir=None, **cfg_kw,
            ),
            device=device,
        )
        # the timed epoch replays the SAME epoch-0 stream (train_epoch does
        # not advance trainer.epoch), so both epochs and both paths see one
        # stream; train_epoch ends in its host sync of the losses
        with watchdog.phase(f"{name}_warmup"):
            trainer.train_epoch()
        with watchdog.phase(f"{name}_timed"):
            m = trainer.train_epoch()
        shapes = step_shapes(trainer)
        book_step_programs(shapes, trainer.model, epochs=2)
        return {
            "epoch_s": round(m["epoch_seconds"], 4),
            "steps": m["num_steps"],
            "padded_tokens": m["padded_tokens"],
            "real_tokens": m["real_tokens"],
            "padded_tokens_per_s": round(m["tokens_per_sec"], 1),
            "real_tokens_per_s": round(m["real_tokens_per_sec"], 1),
            "compiled_step_shapes": len(shapes),
        }

    pad = run_path("pad_to_max", train_buckets=None, dedup_anchors=False)
    bucketed = run_path("bucketed_dedup")  # defaults: pow2 grid + dedup

    print(
        json.dumps(
            {
                "metric": "train_step_microbench",
                "value": round(pad["epoch_s"] / max(bucketed["epoch_s"], 1e-9), 3),
                "unit": "x (pad_to_max_s / bucketed_dedup_s)",
                "vs_baseline": 0.0,  # no external training baseline
                "pad_to_max": pad,
                "bucketed_dedup": bucketed,
                "config": {
                    "model": os.environ.get("BENCH_MODEL", "base"),
                    "seq_len": seq_len,
                    "batch_size": batch,
                    "grad_accum": accum,
                    "steps_per_epoch": steps,
                },
                **_program_blocks(),
            }
        )
    )


def _run_tune_micro() -> None:
    """BENCH_MICRO=tune (or BENCH_TUNE=1): the offline autotuner as a
    bench leg — one tuned-vs-default JSON record.

    Runs :func:`memvul_tpu_torch.tuning.autotune.run_tune` in-process over
    the slim knob grids, then reports the tuned winner against the
    hand-set defaults on BOTH microbenches (real-token train throughput,
    serve requests/sec) with the parity-gate refusal count.  The headline
    ``value`` is the geometric mean of the available speedups.

    Knobs: BENCH_MODEL (tiny | base, default tiny), BENCH_SEQ_LEN (128),
    BENCH_TUNE_MODE (train | serve | all), BENCH_TUNE_CASCADE=1,
    BENCH_TUNE_OUT (the profile store), BENCH_TRAIN_STEPS /
    BENCH_TRAIN_BATCH, BENCH_MICRO_REQUESTS / BENCH_MICRO_CLIENTS /
    BENCH_SERVE_MAX_BATCH.
    """
    from memvul_tpu_torch.tuning.autotune import run_tune

    watchdog = _watchdog()
    device = _device()
    mode = os.environ.get("BENCH_TUNE_MODE", "all")
    bench_kwargs = dict(
        seed=0,
        model_size=os.environ.get("BENCH_MODEL", "tiny"),
        seq_len=int(os.environ.get("BENCH_SEQ_LEN", "128")),
        batch_size=int(os.environ.get("BENCH_TRAIN_BATCH", "8")),
        steps_per_epoch=int(os.environ.get("BENCH_TRAIN_STEPS", "4")),
        n_requests=int(os.environ.get("BENCH_MICRO_REQUESTS", "96")),
        n_clients=int(os.environ.get("BENCH_MICRO_CLIENTS", "4")),
        max_batch=int(os.environ.get("BENCH_SERVE_MAX_BATCH", "8")),
    )
    with watchdog.phase("tune_sweep"):
        record = run_tune(
            mode,
            allow_unknown_device=True,  # a CPU harness run is measurement-only
            out_dir=os.environ.get("BENCH_TUNE_OUT") or None,
            cascade=os.environ.get("BENCH_TUNE_CASCADE") == "1",
            bench_kwargs=bench_kwargs,
            train_space_kwargs=dict(
                bucket_grids=[None, "pow2"], dedup_options=(True,),
                prefetch_depths=(2, 8),
            ),
            serve_space_kwargs=dict(
                wait_ms_options=(2.0, 5.0), budget_factors=(2, 4),
                rows_factors=(1,),
            ),
            device=device,
        )

    speedups = [
        s for s in (
            (record.get("train") or {}).get("speedup_real_tokens"),
            (record.get("serve") or {}).get("speedup_rps"),
        ) if s
    ]
    value = round(float(np_geomean(speedups)) if speedups else 0.0, 3)

    def _leg(section, metric_key):
        block = record.get(section) or {}
        winner = block.get("winner") or {}
        return {
            "default_knobs": block.get("default_knobs"),
            "default": block.get("default_bench"),
            "tuned_knobs": (
                winner.get("prune", {}).get("candidate", {}).get("knobs")
            ),
            "tuned": winner.get("bench"),
            "speedup": block.get(metric_key),
            "parity": (winner.get("parity") or {}).get("passed"),
        }

    parity_refused = sum(
        1
        for section in ("train", "serve")
        for row in (record.get(section) or {}).get("candidates", [])
        if row.get("parity") and not row["parity"]["passed"]
    )
    print(
        json.dumps(
            {
                "metric": "tune_microbench",
                "value": value,
                "unit": "x geomean(tuned/default: train real-tokens, serve rps)",
                "vs_baseline": 0.0,  # no external tuning baseline
                "device_class": record.get("device_class"),
                "mode": mode,
                "train": _leg("train", "speedup_real_tokens"),
                "serve": _leg("serve", "speedup_rps"),
                "cascade": record.get("cascade"),
                "parity_refused": parity_refused,
                "profile_path": record.get("profile_path"),
                "config": record.get("bench"),
                **_program_blocks(),
            }
        )
    )


def np_geomean(values):
    """Geometric mean of the positive values (0.0 when there is none)."""
    import math

    vals = [float(v) for v in values if v and v > 0]
    if not vals:
        return 0.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def _run_serve_micro() -> None:
    """BENCH_MICRO=serve: latency/throughput of the online scoring service.

    Closed-loop load: BENCH_MICRO_CLIENTS in-process client threads each
    score their share of BENCH_MICRO_REQUESTS mixed-length reports
    through the micro-batcher (deadlines off — this measures the service,
    not the shed path) and record end-to-end latencies.  One JSON line
    reports requests/sec plus the latency percentiles.

    Router mode (BENCH_SERVE_REPLICAS > 1, or BENCH_SERVE_AUTOSCALE=1):
    the same load drives a ``ReplicaRouter`` over that many replica
    services through the SLO harness (``serving/loadgen.py``).
    """
    import queue as _queue

    import numpy as np

    from memvul_tpu_torch.config import SERVING_DEFAULTS as _serving_defaults
    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.serving import InprocessClient, ScoringService, ServiceConfig
    from memvul_tpu_torch.telemetry import Registry, get_registry

    watchdog = _watchdog()
    device = _device()
    n_requests = int(os.environ.get("BENCH_MICRO_REQUESTS", "2048"))
    n_clients = int(os.environ.get("BENCH_MICRO_CLIENTS", "8"))
    max_batch = int(os.environ.get("BENCH_SERVE_MAX_BATCH", "16"))
    max_wait_ms = float(os.environ.get("BENCH_SERVE_WAIT_MS", "5"))
    seq_len = int(os.environ.get("BENCH_SEQ_LEN", "512"))
    n_replicas = int(os.environ.get("BENCH_SERVE_REPLICAS", "1"))
    n_anchors = 129

    with watchdog.phase("workspace"):
        ws = build_workspace(
            tempfile.mkdtemp(), seed=0, num_projects=8,
            reports_per_project=64, realistic_lengths=True,
        )
    model, seq_len = bench_model(ws["tokenizer"].vocab_size,
                                 os.environ.get("BENCH_MODEL", "base"), seq_len)
    buckets = tuple(b for b in (64, 128, 256, 512) if b <= seq_len) or (seq_len,)
    with watchdog.phase("model_init"):
        model = model.to(device).eval()
        _sync(device)

    reader = MemoryReader(
        cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"]
    )
    texts = [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]
    while len(texts) < n_requests:
        texts = texts + texts
    texts = texts[:n_requests]
    anchor_instances = _anchor_instances(ws, n_anchors)

    # BENCH_SERVE_IMPL: one dispatch strategy, or "ab": all four over the
    # identical seeded schedule (the padding, admission and quantization
    # wins in one record)
    impl_mode = os.environ.get("BENCH_SERVE_IMPL", "bucketed")
    if impl_mode not in ("bucketed", "ragged", "continuous", "cascade", "ab"):
        raise SystemExit(
            "BENCH_SERVE_IMPL must be bucketed|ragged|continuous|cascade|ab, "
            f"got {impl_mode!r}"
        )
    band_env = os.environ.get("BENCH_CASCADE_BAND")
    if band_env:
        try:
            cascade_low, cascade_high = (float(x) for x in band_env.split(","))
        except ValueError:
            raise SystemExit(
                f"BENCH_CASCADE_BAND must be 'low,high', got {band_env!r}"
            )
    else:
        cascade_low = float(_serving_defaults["cascade_low"])
        cascade_high = float(_serving_defaults["cascade_high"])
    # the queue_wait comparison needs the per-stage trace histograms;
    # tracing stays off for single-leg runs
    trace_rate = float(
        os.environ.get(
            "BENCH_SERVE_TRACE_RATE", "1.0" if impl_mode == "ab" else "0.0"
        )
    )
    # the admission-cache leg: an exact-duplicate cache and the seeded
    # dedup schedule (serving/loadgen.py)
    cache_on = os.environ.get("BENCH_SERVE_CACHE") == "1"
    cache_capacity = (
        int(os.environ.get("BENCH_SERVE_CACHE_CAPACITY", "512"))
        if cache_on else 0
    )
    if cache_on:
        from memvul_tpu_torch.serving.loadgen import LoadConfig, request_texts

        texts = request_texts(
            LoadConfig(
                pattern="dedup",
                requests=n_requests,
                dedup_unique=int(os.environ.get("BENCH_SERVE_CACHE_UNIQUE", "32")),
                seed=0,
            ),
            texts,
        )
    service_config = ServiceConfig(
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_queue=max(256, 2 * n_clients * max_batch),
        default_deadline_ms=0.0,  # measure latency, don't shed it
        trace_sample_rate=trace_rate,
        cache_capacity=cache_capacity,
    )
    token_budget = int(
        os.environ.get("BENCH_SERVE_TOKEN_BUDGET", str(4 * seq_len))
    )

    def build_service(registry=None, impl: str = "bucketed") -> ScoringService:
        if impl in ("ragged", "continuous"):
            kwargs = dict(
                score_impl=impl, token_budget=token_budget,
                max_rows_per_pack=max_batch,
            )
        elif impl == "cascade":
            kwargs = dict(
                score_impl="cascade", encoder_precision="int8",
                cascade_low=cascade_low, cascade_high=cascade_high,
            )
        else:
            kwargs = {}
        predictor = SiamesePredictor(
            model, ws["tokenizer"],
            batch_size=max_batch, max_length=seq_len, buckets=buckets,
            **kwargs,
        )
        predictor.encode_anchors(anchor_instances)
        return ScoringService(predictor, config=service_config, registry=registry)

    if n_replicas > 1 or os.environ.get("BENCH_SERVE_AUTOSCALE") == "1":
        router_impl = "bucketed" if impl_mode == "ab" else impl_mode
        _run_serve_router_micro(
            watchdog,
            lambda registry=None: build_service(registry, impl=router_impl),
            texts,
            n_requests=n_requests, n_clients=n_clients,
            n_replicas=n_replicas, seq_len=seq_len, buckets=buckets,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
        )
        return

    def _drive_leg(impl: str, tsdb_cadence: float = 0.0, tag: str = "") -> dict:
        """One closed-loop run: build the service for ``impl``, push the
        SAME seeded text schedule through it, return the leg record."""
        registry = Registry()
        with watchdog.phase(f"anchor_encode_{impl}{tag}"):
            service = build_service(registry=registry, impl=impl)
            _sync(device)
        sampler = None
        if tsdb_cadence > 0:
            from memvul_tpu_torch.telemetry.timeseries import MetricsSampler

            sampler = MetricsSampler(service, cadence_s=tsdb_cadence, registry=registry)
        client = InprocessClient(service)
        work: "_queue.SimpleQueue" = _queue.SimpleQueue()
        for text in texts:
            work.put(text)
        latencies: list = []
        lat_lock = threading.Lock()
        errors = [0]

        def _client_loop():
            own: list = []
            n_err = 0
            while True:
                try:
                    text = work.get_nowait()
                except _queue.Empty:
                    break
                t0 = time.perf_counter()
                resp = client.score(text, deadline_ms=0)
                own.append(time.perf_counter() - t0)
                if resp["status"] != "ok":
                    n_err += 1
            with lat_lock:
                latencies.extend(own)
                errors[0] += n_err

        with watchdog.phase(f"serve_warmup_{impl}{tag}"):
            client.score(texts[0], deadline_ms=0)
        # each response is on the host when its client gets it, so the
        # load's clock ends after the device's last batch
        with watchdog.phase(f"serve_load_{impl}{tag}"):
            threads = [
                threading.Thread(target=_client_loop, daemon=True)
                for _ in range(n_clients)
            ]
            start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.perf_counter() - start
        if sampler is not None:
            sampler.stop()
        service.drain()
        snap = registry.snapshot()
        counters = snap["counters"]
        # the packs and blocks behind the kernels' launches, per leg
        get_registry().counter(f"bench.serve.{impl}{tag}.batches").inc(
            int(counters.get("serve.batches", 0)))
        real = int(counters.get("serve.tokens_real", 0))
        padded = int(counters.get("serve.tokens_padded", 0))
        qw = snap.get("histograms", {}).get("serve.queue_wait_s")
        queue_wait_ms = (
            {"p50": round(qw["p50"] * 1e3, 3), "p95": round(qw["p95"] * 1e3, 3)}
            if qw and qw.get("count") else None
        )
        lat_ms = np.sort(np.asarray(latencies)) * 1e3
        pct = (
            lambda q: round(float(np.percentile(lat_ms, q)), 3)
            if len(lat_ms) else None
        )
        leg = {
            "impl": impl,
            "requests_per_sec": round(n_requests / elapsed, 1),
            "latency_ms": {
                "p50": pct(50), "p95": pct(95), "p99": pct(99),
                "max": round(float(lat_ms[-1]), 3) if len(lat_ms) else None,
                "mean": round(float(lat_ms.mean()), 3) if len(lat_ms) else None,
            },
            "errors": errors[0],
            # the padding ledger: tokens requests carried vs token slots
            # the dispatched shapes paid for
            "real_tokens": real,
            "padded_tokens": padded,
            "real_token_utilization": round(real / padded, 4) if padded else None,
            "queue_wait_ms": queue_wait_ms,
        }
        if sampler is not None:
            ts = snap.get("histograms", {}).get("tsdb.sample_s")
            leg["tsdb"] = {
                "cadence_s": tsdb_cadence,
                "samples": int(counters.get("tsdb.samples", 0)),
                "sample_errors": int(counters.get("tsdb.sample_errors", 0)),
                "series": sampler.store.series_count,
                "sample_ms": (
                    {"mean": round(ts["mean"] * 1e3, 3),
                     "p95": round(ts["p95"] * 1e3, 3)}
                    if ts and ts.get("count") else None
                ),
            }
        if cache_on:
            # a hit is a device call avoided; tokens_saved the real tokens
            # the tokenizer and the device never saw
            hits = int(counters.get("cache.hits", 0))
            misses = int(counters.get("cache.misses", 0))
            leg["cache"] = {
                "capacity": cache_capacity,
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hits / (hits + misses), 4) if (hits + misses) else None,
                "device_calls_avoided": hits,
                "real_tokens_saved": int(counters.get("cache.tokens_saved", 0)),
                "evictions": int(counters.get("cache.evictions", 0)),
            }
        if impl == "cascade":
            rescored = int(counters.get("serve.cascade_rescored", 0))
            shortcut = int(counters.get("serve.cascade_shortcircuit", 0))
            leg["cascade_rescored"] = rescored
            leg["cascade_shortcircuit"] = shortcut
            leg["cascade_rescore_rate"] = (
                round(rescored / (rescored + shortcut), 4)
                if (rescored + shortcut) else None
            )
            leg["cascade_band"] = [cascade_low, cascade_high]
        return leg

    legs = (
        ["bucketed", "ragged", "continuous", "cascade"] if impl_mode == "ab"
        else [impl_mode]
    )
    records = [_drive_leg(impl) for impl in legs]
    by_leg = {leg["impl"]: leg for leg in records}
    # the ab headline stays the continuous leg; single-leg runs report
    # their own leg
    primary = by_leg["continuous"] if impl_mode == "ab" else records[-1]
    tsdb_cadence = float(os.environ.get("BENCH_SERVE_TSDB_CADENCE", "0.0"))
    tsdb_on = (
        _drive_leg(primary["impl"], tsdb_cadence=tsdb_cadence, tag="_tsdb")
        if tsdb_cadence > 0 else None
    )
    record = {
        "metric": "serve_microbench",
        "value": primary["requests_per_sec"],
        "unit": "requests/sec",
        "vs_baseline": 0.0,  # no serving baseline exists
        "impl": primary["impl"],
        "latency_ms": primary["latency_ms"],
        "errors": primary["errors"],
        "real_tokens": primary["real_tokens"],
        "padded_tokens": primary["padded_tokens"],
        "real_token_utilization": primary["real_token_utilization"],
        "queue_wait_ms": primary["queue_wait_ms"],
        **{
            k: primary[k]
            for k in (
                "cascade_rescored", "cascade_shortcircuit",
                "cascade_rescore_rate", "cascade_band", "cache",
            )
            if k in primary
        },
        "config": {
            "model": os.environ.get("BENCH_MODEL", "base"),
            "seq_len": seq_len,
            "buckets": list(buckets),
            "requests": n_requests,
            "clients": n_clients,
            "max_batch": max_batch,
            "max_wait_ms": max_wait_ms,
            "impl_mode": impl_mode,
            "token_budget": token_budget,
            "cache_capacity": cache_capacity,
        },
        **_program_blocks(),
    }
    if tsdb_on is not None:
        off_rps = primary["requests_per_sec"]
        record["tsdb"] = {
            "cadence_s": tsdb_cadence,
            "off": {"requests_per_sec": off_rps, "latency_ms": primary["latency_ms"]},
            "on": {"requests_per_sec": tsdb_on["requests_per_sec"],
                   "latency_ms": tsdb_on["latency_ms"]},
            "sampler": tsdb_on.get("tsdb"),
            "throughput_ratio": (
                round(tsdb_on["requests_per_sec"] / off_rps, 4) if off_rps else None
            ),
        }
    if impl_mode == "ab":
        record["ab"] = by_leg
        bucketed_util = by_leg["bucketed"]["real_token_utilization"]
        ragged_util = by_leg["ragged"]["real_token_utilization"]
        if bucketed_util and ragged_util:
            record["utilization_gain"] = round(ragged_util / bucketed_util, 3)
        # the continuous win: p50 admission wait against the
        # seal-then-admit ragged loop on the identical seeded schedule
        ragged_qw = by_leg["ragged"]["queue_wait_ms"]
        cont_qw = by_leg["continuous"]["queue_wait_ms"]
        if ragged_qw and cont_qw and cont_qw["p50"]:
            record["queue_wait_gain"] = round(ragged_qw["p50"] / cont_qw["p50"], 2)
        casc = by_leg.get("cascade")
        if casc:
            record["cascade_rescore_rate"] = casc["cascade_rescore_rate"]
            bucketed_rps = by_leg["bucketed"]["requests_per_sec"]
            if bucketed_rps:
                record["cascade_throughput_gain"] = round(
                    casc["requests_per_sec"] / bucketed_rps, 3
                )
    print(json.dumps(record))


def _run_serve_router_micro(
    watchdog, build_service, texts, *, n_requests, n_clients, n_replicas,
    seq_len, buckets, max_batch, max_wait_ms,
) -> None:
    """The router leg of BENCH_MICRO=serve: N replica services behind a
    ``ReplicaRouter``, driven by the deterministic load generator, one
    JSON record with per-cause outcome counts and per-replica utilization.

    Autoscale leg (BENCH_SERVE_AUTOSCALE=1): the fleet starts at ONE
    replica with an ``Autoscaler`` closing the scale_hint loop
    (BENCH_SERVE_REPLICAS is the max), the pattern defaults to diurnal,
    and the record gains the replica-count trajectory, per-phase SLO burn,
    scale-event counts and the lost-request count, which must be 0."""
    from memvul_tpu_torch.serving import (
        LoadConfig,
        Replica,
        ReplicaRouter,
        RouterConfig,
        run_slo_harness,
    )
    from memvul_tpu_torch.serving.slo import SLOConfig, SLOMonitor
    from memvul_tpu_torch.telemetry import Registry

    autoscale = os.environ.get("BENCH_SERVE_AUTOSCALE") == "1"
    pattern = os.environ.get(
        "BENCH_SERVE_PATTERN", "diurnal" if autoscale else "closed"
    )
    rps = float(os.environ.get("BENCH_SERVE_RPS", "200"))
    diurnal_period_s = float(os.environ.get("BENCH_SERVE_PERIOD_S", "2.0"))
    max_replicas = max(n_replicas, 2) if autoscale else n_replicas
    with watchdog.phase("replica_warmup"):
        replicas = [
            Replica(i, lambda registry: build_service(registry=registry),
                    telemetry_enabled=True)
            for i in range(1 if autoscale else n_replicas)
        ]
    router_registry = Registry()
    router = ReplicaRouter(replicas, config=RouterConfig(), registry=router_registry)
    router.slo_monitor = SLOMonitor(
        router, registry=router_registry, config=SLOConfig(interval_s=1.0), start=False,
    )
    router.slo_monitor.tick()  # the pre-load baseline sample
    scaler = None
    ticker_stop = threading.Event()
    ticker = None
    if autoscale:
        from memvul_tpu_torch.serving.autoscaler import Autoscaler, AutoscalerConfig

        scaler = Autoscaler(
            router,
            replica_factory=lambda index: (
                lambda registry: build_service(registry=registry)
            ),
            slo_monitor=router.slo_monitor,
            # the diurnal period is seconds, so cooldowns compress with it
            config=AutoscalerConfig(
                min_replicas=1, max_replicas=max_replicas,
                interval_s=0.1, up_cooldown_s=0.3, down_cooldown_s=0.5,
                up_consecutive=1, down_consecutive=2,
                drain_timeout_s=30.0,
            ),
            registry=router_registry,
            start=False,  # the ticker thread below paces the ticks
        )
        router.autoscaler = scaler

        def _drive() -> None:
            # the closed control loop: sample the SLO, act on the hint;
            # sync=True keeps one spawn/retire at a time
            while not ticker_stop.wait(0.1):
                try:
                    router.slo_monitor.tick()
                    scaler.tick(sync=True)
                except Exception:
                    pass  # one bad sample must not end the bench loop

        ticker = threading.Thread(target=_drive, name="bench-autoscale-ticker", daemon=True)
    load = LoadConfig(
        pattern=pattern, requests=n_requests, clients=n_clients, rps=rps,
        diurnal_period_s=diurnal_period_s,
        deadline_ms=None if pattern != "slowloris" else 60_000.0,
    )
    with watchdog.phase("serve_warmup"):
        router.submit(texts[0], deadline_ms=0).result(timeout=120)
    with watchdog.phase("serve_load"):
        if ticker is not None:
            ticker.start()
        try:
            record = run_slo_harness(router, texts, config=load)
        finally:
            ticker_stop.set()
            if ticker is not None:
                ticker.join(timeout=30)
    router.drain()

    report = record["load"]
    fleet = record.get("fleet", {})
    autoscale_block = None
    if scaler is not None:
        counters = router_registry.snapshot()["counters"]
        members = fleet.get("replicas", [])
        # hangs + any invariant deficit: a request admitted somewhere but
        # never served, shed or errored
        deficit = sum(
            m["requests"] - m["served"] - m["shed"] - m["errors"] for m in members
        )
        lost = report["outcomes"]["hang"] + max(0, deficit)
        phase_names = ("rise", "peak", "fall", "trough")
        phases = {name: [] for name in phase_names}
        for point in scaler.history:
            frac = (point["t_s"] % diurnal_period_s) / diurnal_period_s
            phases[phase_names[min(3, int(frac * 4))]].append(point)
        autoscale_block = {
            "min_replicas": 1,
            "max_replicas": max_replicas,
            "final_replicas": len(router._members()),
            "scale_ups": counters.get("scaler.scale_ups", 0),
            "scale_downs": counters.get("scaler.scale_downs", 0),
            "spawn_failures": counters.get("scaler.spawn_failures", 0),
            "lost_requests": lost,  # MUST be 0
            "replica_trajectory": [
                {k: point[k] for k in ("t_s", "replicas", "hint", "action")}
                for point in scaler.history
            ],
            "phase_burn": {
                name: {
                    "ticks": len(points),
                    "mean_replicas": (
                        round(sum(p["replicas"] for p in points) / len(points), 2)
                        if points else None
                    ),
                    "max_burn_fast": max(
                        (p["burn_rate_fast"] or 0.0 for p in points), default=None,
                    ),
                }
                for name, points in phases.items()
            },
        }
    print(
        json.dumps(
            {
                "metric": (
                    "serve_autoscale_microbench" if autoscale
                    else "serve_router_microbench"
                ),
                "value": report["achieved_rps"],
                "unit": "requests/sec",
                "vs_baseline": 0.0,  # no router baseline exists
                "latency_ms": report["latency_ms"],
                "outcomes": report["outcomes"],
                "offered_rps": report["offered_rps"],
                "duration_s": report["duration_s"],
                "fleet": {
                    "invariant_ok": fleet.get("invariant_ok"),
                    "served_total": fleet.get("served_total"),
                    "replicas": [
                        {
                            "name": member["name"],
                            "served": member["served"],
                            "shed": member["shed"],
                            "errors": member["errors"],
                            "restarts": member["restarts"],
                            "utilization": member["utilization"],
                        }
                        for member in fleet.get("replicas", [])
                    ],
                },
                "router": record.get("router", {}),
                "slo": record.get("slo", {}),
                "autoscale": autoscale_block,
                "config": {
                    "model": os.environ.get("BENCH_MODEL", "base"),
                    "seq_len": seq_len,
                    "buckets": list(buckets),
                    "requests": n_requests,
                    "clients": n_clients,
                    "replicas": n_replicas,
                    "pattern": pattern,
                    "rps": rps,
                    "max_batch": max_batch,
                    "max_wait_ms": max_wait_ms,
                },
            }
        )
    )


def _run_corpus_micro() -> None:
    """BENCH_MICRO=corpus: sharded corpus scoring throughput.

    Builds a tiny untrained archive over a synthetic workspace, runs
    ``score_corpus`` across BENCH_CORPUS_SHARDS supervised worker
    subprocesses on the bench's device, and reports total rows/s plus the
    per-shard rates the coordinator's merge verified exactly-once.  The
    number measures the distribution machinery (spawn, heartbeat
    supervision, journal replay, merge verification), not the model.

    Knobs: BENCH_CORPUS_SHARDS (2), BENCH_CORPUS_REPORTS (workspace
    reports per project, 64), BENCH_SEQ_LEN (64).
    """
    from pathlib import Path

    from memvul_tpu_torch.archive import save_archive
    from memvul_tpu_torch.build import build_model, init_params
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.distributed import score_corpus
    from memvul_tpu_torch.models.convert import flax_from_params
    from memvul_tpu_torch.telemetry.sinks import HeartbeatFile

    watchdog = _watchdog()
    device = _device()
    n_shards = int(os.environ.get("BENCH_CORPUS_SHARDS", "2"))
    per_project = int(os.environ.get("BENCH_CORPUS_REPORTS", "64"))
    seq_len = int(os.environ.get("BENCH_SEQ_LEN", "64"))

    with watchdog.phase("workspace"):
        ws = build_workspace(
            tempfile.mkdtemp(), seed=0, num_projects=8,
            reports_per_project=per_project, realistic_lengths=True,
        )
    root = Path(tempfile.mkdtemp())
    model_cfg = {
        "type": "model_memory",
        "encoder": {"preset": "tiny", "vocab_size": ws["tokenizer"].vocab_size},
        "header_dim": 32,
    }
    config = {
        "tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
        "dataset_reader": {
            "type": "reader_memory",
            "anchor_path": ws["paths"]["anchors"],
            "cve_path": ws["paths"]["cve"],
        },
        "model": model_cfg,
        "evaluation": {"batch_size": 8, "max_length": seq_len},
        "telemetry": {"heartbeat_every_s": 1.0},
    }
    with watchdog.phase("archive"):
        model = init_params(build_model(dict(model_cfg), ws["tokenizer"].vocab_size), seed=0)
        archive = save_archive(
            root / "model.tar.gz", config,
            flax_from_params(model.state_dict(), model.config),
            tokenizer_file=ws["paths"]["tokenizer"],
        )

    out_dir = root / "corpus_run"
    with watchdog.phase("score_corpus"):
        t0 = time.perf_counter()
        result = score_corpus(
            archive, ws["paths"]["test"], out_dir, shards=n_shards, device=device.type,
        )
        wall = time.perf_counter() - t0

    per_shard = []
    for summary in result["shards"]:
        hb = HeartbeatFile(out_dir / summary["shard"] / "HEARTBEAT.json").read()
        uptime = float(hb.get("uptime_s") or 0.0)
        rows = summary["rows"]
        per_shard.append({
            "shard": summary["shard"],
            "rows": rows,
            "restarts": summary["restarts"],
            "rows_per_s": round(rows / uptime, 2) if uptime > 0 else 0.0,
        })

    print(
        json.dumps(
            {
                "metric": "corpus_microbench",
                "value": round(result["corpus_rows"] / max(wall, 1e-9), 2),
                "unit": "rows/s",
                "vs_baseline": 0.0,  # no corpus-scoring baseline
                "corpus_rows": result["corpus_rows"],
                "wall_s": round(wall, 3),
                "merge_wall_s": round(result["merge_wall_s"], 3),
                "restarts": result["restarts"],
                "per_shard": per_shard,
                "verification": result["verification"],
                "config": {
                    "shards": n_shards,
                    "seq_len": seq_len,
                    "reports_per_project": per_project,
                },
                **_program_blocks(),
            }
        )
    )


def _extract_result_line(text: str):
    """Last stdout line that parses as the bench result dict, else None.

    Records carrying an ``error`` field (the watchdog's phase-timeout
    record) are NOT results — skipping them here is what lets the
    supervisor retry a watchdog-killed attempt instead of reporting its
    failure record as a measurement."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj and "error" not in obj:
            return line
    return None


def _kill_process_group(proc: "subprocess.Popen", grace: float = 0.0) -> None:
    """Kill the child's whole process group — nothing may be left holding
    the card after a timed-out attempt.  With ``grace`` > 0, SIGTERM first
    and give the child that long to exit cleanly (and release its CUDA
    context) before SIGKILL."""
    if grace > 0:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=grace)
            return
        except (ProcessLookupError, PermissionError, OSError):
            pass
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
    try:
        proc.wait(timeout=10)
    except Exception:
        pass


# the device probe: a tiny matmul on BENCH_DEVICE and a synchronize.  Exit
# 3 means no CUDA device at all, which waiting does not cure
_PROBE_BODY = (
    "import os, sys, torch\n"
    "device = os.environ.get('BENCH_DEVICE', 'cuda')\n"
    "if device.startswith('cuda') and not torch.cuda.is_available():\n"
    "    sys.stderr.write('no CUDA device is visible (BENCH_DEVICE=cpu runs the bench "
    "on the CPU)\\n')\n"
    "    sys.exit(3)\n"
    "x = torch.ones((8, 128), device=device)\n"
    "s = float((x @ x.T).sum())\n"
    "if device.startswith('cuda'): torch.cuda.synchronize()\n"
    "print('DEVICE_OK', s)\n"
)
_PROBE_NO_DEVICE = 3


def _wait_for_device(
    total_budget: float, probe_timeout: float, interval: float, env=None, why=None,
) -> bool:
    """Block until the device answers a trivial op, or give up.

    A wedged device makes the bench child HANG at its first device op
    rather than error; spending cheap probes until it answers is cheaper
    than burning full attempt timeouts.  Returns False once
    ``total_budget`` seconds have elapsed without an answer, or at once
    when the probe finds no CUDA device at all; ``why`` (a list) receives
    the last probe's error line."""
    deadline = time.monotonic() + total_budget
    first = True
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        proc = subprocess.Popen(
            [sys.executable, "-c", _PROBE_BODY],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            start_new_session=True,
        )
        try:
            out, err = proc.communicate(timeout=min(probe_timeout, remaining))
        except subprocess.TimeoutExpired:
            # graceful first: a SIGTERM'd probe releases its context cleanly
            _kill_process_group(proc, grace=10.0)
            out, err = "", f"probe timed out after {min(probe_timeout, remaining):.0f}s"
        if "DEVICE_OK" in (out or ""):
            return True
        if why is not None:
            lines = [ln for ln in (err or "").splitlines() if ln.strip()]
            why[:] = lines[-1:]
        if proc.returncode == _PROBE_NO_DEVICE:
            return False
        if first:
            sys.stderr.write("bench: device not answering; probing until it recovers\n")
            first = False
        if time.monotonic() + interval >= deadline:
            return False
        time.sleep(interval)


def _supervise(cmd, attempts: int, attempt_timeout: float, backoff: float, env=None):
    """Run ``cmd`` until it emits a bench-result JSON line.

    Returns (result_line, None) on success or (None, short_error) after the
    retry budget is exhausted.  Only transient failures (the shared
    classification in resilience/retry.py) and deadline kills are retried;
    a genuine bug fails fast.
    """
    policy = RetryPolicy(attempts=attempts, backoff=backoff)
    last_error = "no attempts were made"
    for attempt in range(1, attempts + 1):
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            start_new_session=True,  # own process group, killable as a unit
        )
        try:
            out, err = proc.communicate(timeout=attempt_timeout)
            timed_out = False
        except subprocess.TimeoutExpired:
            _kill_process_group(proc)
            # harvest whatever the child wrote before hanging — a result
            # line printed before a teardown hang is still a result
            try:
                out, err = proc.communicate(timeout=10)
            except Exception:
                out, err = "", ""
            out, err, timed_out = out or "", err or "", True

        # the child's logs must reach the operator even when it succeeds
        if err:
            sys.stderr.write(err if len(err) < 20000 else err[-20000:])

        line = _extract_result_line(out)
        if line is not None:
            return line, None
        if not timed_out and proc.returncode == 0:
            # deterministic bug (result contract broken): fail fast
            return None, "child exited 0 without a result line"
        if timed_out:
            last_error = f"attempt timed out after {attempt_timeout:.0f}s"
        else:
            # the real error lives on stderr; stdout only as a fallback so
            # progress noise can't mask the exception text
            err_lines = [l for l in (err or "").splitlines() if l.strip()]
            out_lines = [l for l in (out or "").splitlines() if l.strip()]
            tail = err_lines or out_lines
            # prefer the actual exception line over trailing boilerplate
            exc = [l for l in tail if re.match(r"^[\w.]+(Error|Exception)\b", l)]
            pick = exc[-1] if exc else (tail[-1] if tail else None)
            last_error = pick[:300] if pick else f"rc={proc.returncode}"
            if not policy.is_transient(err + out):
                return None, last_error  # not transient: don't burn retries

        if attempt < attempts:
            sys.stderr.write(
                f"bench attempt {attempt}/{attempts} failed ({last_error}); "
                f"retrying in {policy.delay(attempt):.0f}s\n"
            )
            time.sleep(policy.delay(attempt))
    return None, last_error


def _record_launches() -> None:
    """The kernels' launch counts of this child into the process registry
    (``kernels.launches.<kernel>`` in telemetry.json)."""
    from memvul_tpu_torch.ops import (anchor_match, flash_attention, moe, plain_attention,
                                      ragged_attention)
    from memvul_tpu_torch.telemetry import get_registry

    tel = get_registry()
    modules = (anchor_match, flash_attention, ragged_attention, plain_attention, moe)
    for name, module in zip(KERNEL_MODULES, modules):
        tel.counter(f"kernels.launches.{name}").inc(int(module.launches))
    tel.counter("kernels.launches.flash_attention_causal").inc(int(flash_attention.causal_launches))
    tel.counter("kernels.plain_on_card").inc(int(plain_attention.plain_on_card))
    tel.counter("moe.pairs_routed").inc(int(moe.pairs_routed))


def _error_record(error: str) -> dict:
    return {"metric": _metric_name(), "value": 0.0, "unit": "reports/sec",
            "vs_baseline": 0.0, "error": error}


def _lint_record() -> dict:
    """BENCH_LINT=1: run the static-analysis engine over the port's tree
    and return one parseable JSON record.  The supervisor prints it as its
    own line before the bench result, so a sweep harness collects code
    health beside throughput without a second process."""
    from memvul_tpu_torch.analysis import analyze_repo

    result = analyze_repo()
    return {
        "metric": "lint",
        "clean": not result.active,
        "findings": [f.to_json() for f in result.active],
        "suppressed": len(result.suppressed),
        "baselined": len(result.baselined),
        "files": result.parse_count,
        "elapsed_s": round(result.elapsed_s, 3),
    }


def main() -> int:
    if os.environ.get(_CHILD_ENV_FLAG) == "1":
        # BENCH_TELEMETRY_DIR=<dir>: the child keeps a telemetry run dir
        # (events.jsonl phase spans, HEARTBEAT.json, telemetry.json with
        # the kernels' launch counts), readable through telemetry-report;
        # the registry counts in memory (the watchdog's heartbeat age)
        # either way
        tel_dir = os.environ.get("BENCH_TELEMETRY_DIR")
        if tel_dir:
            from memvul_tpu_torch.telemetry import configure as _tel_configure

            _tel_configure(run_dir=tel_dir, heartbeat_every_s=10.0)
        try:
            _run_bench()
        finally:
            if tel_dir:
                from memvul_tpu_torch.telemetry import get_registry

                _record_launches()
                get_registry().close()
        return 0

    if os.environ.get("BENCH_LINT") == "1":
        # surfaced by the supervisor (one JSON line of its own) so the
        # record rides the same stdout contract as the bench result
        print(json.dumps(_lint_record()))
        sys.stdout.flush()

    attempts = max(1, int(os.environ.get("BENCH_ATTEMPTS", "3")))
    attempt_timeout = float(os.environ.get("BENCH_ATTEMPT_TIMEOUT", "1500"))
    backoff = float(os.environ.get("BENCH_BACKOFF", "20"))

    cmd = [sys.executable, "-m", "memvul_tpu_torch.bench"]
    child_env = dict(os.environ, **{_CHILD_ENV_FLAG: "1"})
    device_wait = float(os.environ.get("BENCH_DEVICE_WAIT", "1800"))
    why: list = []
    if device_wait > 0 and not _wait_for_device(
        device_wait,
        probe_timeout=float(os.environ.get("BENCH_PROBE_TIMEOUT", "240")),
        interval=45.0,
        env=child_env,
        why=why,
    ):
        reason = f": {why[0][:200]}" if why else ""
        print(json.dumps(_error_record(
            f"device did not answer within {device_wait:.0f}s{reason}")))
        return 1
    line, error = _supervise(cmd, attempts, attempt_timeout, backoff, env=child_env)
    if line is not None:
        print(line)
        return 0
    print(json.dumps(_error_record(error)))
    return 1


if __name__ == "__main__":
    sys.exit(main())
