"""Corpus scoring: the program's ``SiamesePredictor.score_instances`` over a
stream of distinct reports, as ``evaluate`` drives it.

Set-up builds the tokenizer from a ``vocab.txt`` of the configuration's
vocabulary, the model from the configuration's ``program`` section (the
port's ``build.build_model``, on the meta device, then filled with the
benchmark's weights on the card), and the predictor from its ``evaluation``
section; it encodes the anchor bank and runs every stream shape once
(``encode_anchors``, ``warmup_compile``).  The weights are drawn from the
seed and rounded to the precision the configuration serves the model in
(:mod:`benchmark.lib.weights`); the program and the reference get the same
rounded values.  Set-up makes the corpus's first chunk; the feed makes the
rest as it reads (:class:`benchmark.lib.traffic.Corpus`), so the stream
never runs dry.

The window feeds the reports through one ``score_instances`` call.  When
``--seconds`` have passed on rank 0's clock, the ranks agree (over a gloo
group on the host, at a batch boundary, so no collective of the harness runs
on the cards) to end the stream: each pauses its feed, they take the largest
count of reports any has fed, and each feeds up to that count, so every rank
ends with the same batches.  The reports whose answers came back inside the
window count; the rest drain after it.

The check, on rank 0, after the program's state is freed: every fed report
came back exactly once (``missing_or_repeated``, limit 0), and a sample of
the answers that came back inside the window, drawn from the seed and
holding the longest report among them, agrees with the reference: the mean
of the sampled answers' errors (:mod:`benchmark.lib.compare`),
``answer_mse``, is within the cell's limit.
"""

from __future__ import annotations

import copy
import math
import sys
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..lib import compare, traffic
from ..lib.traffic import seed_of
from ..lib.weights import make_weights
from ..reference.wordpiece import WordPiece


def _deep_update(base: Dict, over: Dict) -> Dict:
    for k, v in over.items():
        base[k] = _deep_update(dict(base.get(k) or {}), v) if isinstance(v, dict) else v
    return base


class Feed:
    """The instance stream over the corpus, which the predictor's feed
    thread reads; it can be paused and then ended at a count."""

    def __init__(self, corpus: traffic.Corpus) -> None:
        self.corpus = corpus
        self.count = 0
        self.limit = None
        self.paused = False
        self._cond = threading.Condition()

    def __iter__(self):
        i = 0
        while True:
            with self._cond:
                while self.paused:
                    self._cond.wait()
                if self.limit is not None and i >= self.limit:
                    return
                self.count = i + 1
            yield {"text1": self.corpus.text(i), "label": "same", "meta": {"i": i}}
            i += 1

    def pause(self) -> int:
        with self._cond:
            self.paused = True
            return self.count

    def end_at(self, limit: int) -> None:
        with self._cond:
            self.limit = limit
            self.paused = False
            self._cond.notify_all()


def _agree(group, value: int) -> int:
    """The largest ``value`` over the ranks of the host ``group``."""
    if group is None:
        return value
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def served_dtype(cfg: Dict) -> str:
    """The precision the configuration serves the model in."""
    return cfg["program"]["model"]["encoder"]["dtype"]


def program_config(ctx) -> Dict:
    return _deep_update(copy.deepcopy(ctx.config["program"]), ctx.overrides)


def setup(ctx) -> Dict:
    import torch
    from memvul_tpu_torch.build import build_model, build_tokenizer
    from memvul_tpu_torch.config import evaluation_config
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    cfg = ctx.config
    program = program_config(ctx)
    vocab = traffic.build_vocab(cfg["vocab_size"], cfg["vocab_seed"])
    vocab_dir = Path(tempfile.mkdtemp(prefix="perfbench-vocab-"))
    try:
        (vocab_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
        tokenizer = build_tokenizer({"type": "wordpiece", "vocab_path": str(vocab_dir / "vocab.txt")})
    finally:
        shutil.rmtree(vocab_dir, ignore_errors=True)
    wordpiece = WordPiece(vocab)
    pool = traffic.sentence_pool(vocab, ctx.traffic["sentences"], ctx.seed, wordpiece)
    corpus = traffic.Corpus(ctx.traffic, pool, vocab, ctx.seed)
    corpus.text(0)
    anchors = traffic.anchors(cfg["anchors"], pool, vocab, ctx.seed)

    with torch.device("meta"):
        model = build_model(program["model"], vocab_size=len(vocab))
    model = model.to_empty(device=ctx.device)
    weights = make_weights(ctx.reference.parameter_spec(cfg), ctx.seed, ctx.device,
                           served_dtype(cfg))
    params = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != {k: tuple(v.shape) for k, v in weights.items()}:
        raise RuntimeError("the program's parameters are not the configuration's: "
                           f"{sorted(set(shapes) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    del weights
    model.eval()

    ev = evaluation_config(program)
    max_length = min(int(ev["max_length"]), int(cfg["max_position_embeddings"]))
    predictor = SiamesePredictor(
        model, tokenizer, batch_size=int(ev["batch_size"]), max_length=max_length,
        buckets=[int(b) for b in ev["buckets"]] if ev["buckets"] else None,
        tokens_per_batch=int(ev["tokens_per_batch"]) if ev["tokens_per_batch"] else None,
        anchor_match_impl=ev["anchor_match_impl"], mesh=ctx.mesh,
    )
    predictor.encode_anchors(anchors)
    predictor.warmup_compile()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    return {"predictor": predictor, "corpus": corpus,
            "anchors": anchors, "wordpiece": wordpiece, "max_length": max_length,
            "inflight": int(ev["inflight"]),
            "shapes": sorted((length, rows) for rows, length in predictor.stream_shapes())}


def measure(ctx, state) -> Dict:
    predictor = state["predictor"]
    feed = Feed(state["corpus"])
    tracer = ctx.tracer
    tracer.start()
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    stream = predictor.score_instances(iter(feed), inflight=state["inflight"])
    batches = []  # (report indices, answers, time back)
    stopped = False
    while True:
        with tracer.range("perfbench.next"):
            item = next(stream, None)
        if item is None:
            break
        t = time.perf_counter()
        answers, metas = item
        batches.append((np.fromiter((m["i"] for m in metas), np.int64, len(metas)),
                        answers if ctx.rank == 0 else None, t))
        if not stopped:
            with tracer.range("perfbench.agree"):
                if _agree(ctx.host_group, int(ctx.rank == 0 and t >= t_end)):
                    feed.end_at(_agree(ctx.host_group, feed.pause()))
                    stopped = True
            if stopped:
                tracer.stop()
    stream_s = time.perf_counter() - t0
    tracer.stop()
    stats = predictor.stats
    lengths = state["lengths"] = np.minimum(state["corpus"].pieces(), state["max_length"])
    buckets = [length for length, _ in state["shapes"]]
    rows = dict(state["shapes"])
    shapes = []  # per batch in launch order: (this rank's rows, length)
    for idx, _, _ in batches:
        longest = int(lengths[idx].max())
        length = next((b for b in buckets if b >= longest), buckets[-1])
        shapes.append((rows[length] // ctx.chips, length))
    inside = np.concatenate([idx for idx, _, t in batches if t <= t_end] or [np.zeros(0, np.int64)])
    if ctx.rank == 0:
        bins = np.zeros(int(math.ceil(ctx.seconds / 5.0)), np.int64)
        for idx, _, t in batches:
            if t <= t_end:
                bins[min(int((t - t0) / 5.0), len(bins) - 1)] += idx.size
        sys.stderr.write(f"reports back in each 5 s of the window: {bins.tolist()}\n")
    return {"batches": batches, "fed": feed.limit, "window_s": ctx.seconds,
            "reports": int(inside.size), "lengths_in_window": lengths[inside],
            "launches": shapes, "n_anchors": int(len(state["anchors"])),
            "stream": {"seconds": stream_s, "feed_wait_s": stats["feed_wait_s"],
                       "launch_s": stats["launch_s"], "sync_s": stats["sync_s"]},
            "t_end": t_end, "state": state}


def release(ctx, state) -> None:
    import torch

    state.pop("predictor", None)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


def check(ctx, run) -> Dict:
    """Every fed report back exactly once; the sampled answers against the
    reference, on the device the program ran on."""
    state = run.pop("state")
    batches = run["batches"]
    limits = ctx.cell["limits"]
    missing = compare.exactly_once(np.concatenate([idx for idx, _, _ in batches]), run["fed"])
    where = {}
    for b, (idx, _, t) in enumerate(batches):
        if t <= run["t_end"]:
            for row, i in enumerate(idx.tolist()):
                where[i] = (b, row)
    inside = np.array(sorted(where), dtype=np.int64)
    rng = np.random.default_rng(seed_of(ctx.seed, 6))
    lengths = state["lengths"]
    size = min(int(ctx.cell["sample"]), inside.size)
    longest = int(inside[np.argmax(lengths[inside])]) if inside.size else None
    sample = [] if longest is None else [longest] + [
        int(i) for i in rng.choice(inside[inside != longest], size=size - 1, replace=False)]
    errors = np.zeros(0)
    program = reference = np.zeros((0, len(state["anchors"])))
    ref_logits = np.zeros((0, len(state["anchors"]), 2))
    if sample:
        program = np.array([batches[where[i][0]][1][where[i][1]] for i in sample], dtype=np.float64)
        cap, wp = state["max_length"], state["wordpiece"]
        weights = make_weights(ctx.reference.parameter_spec(ctx.config), ctx.seed, ctx.device,
                               served_dtype(ctx.config))
        ref_logits = ctx.reference.logits(
            weights, ctx.config, [wp.encode(state["corpus"].text(i), cap) for i in sample],
            [wp.encode(a["text1"], cap) for a in state["anchors"]])
        del weights
        reference = ctx.reference.answers(ref_logits, served_dtype(ctx.config))
        errors = compare.answer_errors(program, reference)
    mse = float(errors.mean()) if errors.size else float("inf")
    limit = limits["answer_mse"]
    # the sample is judged whole: over its limit, every sampled answer failed
    failed = missing + (0 if mse <= limit else len(sample))
    return {"correct": failed == 0 and errors.size > 0, "attempted": int(run["fed"]),
            "failed": failed, "errors": errors,
            "answers": {"program": program, "reference": reference, "logits": ref_logits,
                        "lengths": lengths[np.array(sample, dtype=np.int64)]},
            "checks": {"answer_mse": compare.check(mse, limit),
                       "missing_or_repeated": compare.check(missing, 0)}}
