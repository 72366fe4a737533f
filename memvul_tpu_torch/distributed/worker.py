"""One shard worker: score a contiguous row span of the corpus (the JAX
package's ``distributed/worker.py``).

The coordinator launches it as ``python -m memvul_tpu_torch.distributed.
worker <spec.json>``, one subprocess per shard, each in its own session.
The spec carries everything the coordinator resolved (archive, span, the
merged evaluation section, explicit bucket boundaries, ``device``), so
every attempt of every shard scores under one configuration.

The worker is the resumable single-process scorer pointed at a slice:
``predict_file(resume=True)`` with the shard's own journal
(``<out>.journal``), dead-letter file and ``HEARTBEAT.json``.  A SIGKILLed
attempt loses nothing it committed: the next attempt's resume skips the
verified prefix.  It runs on the card unless the spec says ``"cpu"``.

Completion is exit 0 and an atomically written ``shard_metrics.json``; exit
0 without the marker counts as a failure.  The worker's ``telemetry.json``
carries its kernels' launch counts (``kernels.launches.<kernel>``) and, on
the card, its peak device memory (``device.peak_bytes``).
"""

from __future__ import annotations

import itertools
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)


class SpanReader:
    """A reader that yields only rows ``[start, end)`` of the
    (post-quarantine) stream, salted with the ``shard.kill`` and
    ``shard.stall`` fault points: ``shard.kill`` (or
    ``shard.kill.<shard>``) fires before a row is yielded; ``shard.stall``
    armed with a ``raise`` wedges the worker (alive, no progress) so that
    the coordinator's stall detector must catch it."""

    def __init__(self, reader, start: int, end: int, shard: str) -> None:
        self._reader = reader
        self.start = int(start)
        self.end = int(end)
        self.shard = shard

    def read(self, file_path: str, split: Optional[str] = None, quarantine=None) -> Iterator[Dict]:
        from ..resilience import faults

        stream = self._reader.read(file_path, split=split, quarantine=quarantine)
        for inst in itertools.islice(stream, self.start, self.end):
            faults.fault_point("shard.kill")
            faults.fault_point(f"shard.kill.{self.shard}")
            try:
                faults.fault_point("shard.stall")
                faults.fault_point(f"shard.stall.{self.shard}")
            except Exception as e:
                logger.warning("injected stall (%s): worker wedged", e)
                while True:  # a hung device call: alive, no progress
                    time.sleep(60.0)
            yield inst


def _record_device_counts(tel, device) -> None:
    """The kernels' launch counts of this process, and its peak device
    memory on the card, into the worker's telemetry."""
    import torch

    from ..ops import anchor_match, flash_attention, moe, plain_attention, ragged_attention

    for name, module in (("anchor_match", anchor_match), ("flash_attention", flash_attention),
                         ("ragged_attention", ragged_attention),
                         ("plain_attention", plain_attention), ("grouped_gemm", moe)):
        tel.counter(f"kernels.launches.{name}").inc(int(module.launches))
    tel.counter("kernels.launches.flash_attention_causal").inc(
        int(flash_attention.causal_launches))
    tel.counter("kernels.plain_on_card").inc(int(plain_attention.plain_on_card))
    if device.type == "cuda":
        tel.gauge("device.peak_bytes").set(torch.cuda.max_memory_allocated(device))


def run_worker(spec_path: str) -> int:
    """Score one shard as its spec file says; returns the exit code."""
    from ..telemetry import Registry

    spec = json.loads(Path(spec_path).read_text())
    shard_dir = Path(spec["shard_dir"])
    ev = spec["evaluation"]
    tel = Registry(run_dir=shard_dir, heartbeat_every_s=float(spec["heartbeat_every_s"]))
    # alive: the stall clock restarts here, before torch loads
    tel.heartbeat(force=True, rows_scored=0, stage="starting")
    import torch

    from ..archive import load_archive
    from ..build import build_reader, resolve_device
    from ..evaluate.predict_memory import SiamesePredictor
    from ..resilience.io import atomic_write_text
    from ..resilience.retry import RetryPolicy

    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cpu":
        # N workers share the host: one thread each
        torch.set_num_threads(1)
    try:
        tel.heartbeat(force=True, rows_scored=0, stage="loading")
        arch = load_archive(spec["archive"], overrides=spec.get("overrides"), device=device)
        reader = build_reader(arch.config.get("dataset_reader"))
        span_reader = SpanReader(reader, spec["start"], spec["end"], spec["name"])
        predictor = SiamesePredictor(
            arch.model, arch.tokenizer,
            batch_size=int(ev["batch_size"]),
            max_length=int(ev["max_length"]),
            buckets=ev["buckets"],
            tokens_per_batch=ev["tokens_per_batch"],
            anchor_match_impl=ev["anchor_match_impl"], telemetry=tel,
        )
        predictor.encode_anchors(reader.read_anchors(spec["golden_file"]))
        if ev["aot_warmup"]:
            predictor.warmup_compile()
        # the first liveness snapshot before scoring: the stall clock starts
        # from real progress, not from the launch
        tel.heartbeat(force=True, rows_scored=0)
        score_retries = int(ev["score_retries"])
        metrics = predictor.predict_file(
            span_reader, spec["test_path"], spec["out_path"],
            split=spec.get("split"),
            inflight=int(ev["inflight"]),
            resume=True,
            quarantine=ev["quarantine"],
            heartbeat_batches=max(1, int(ev["heartbeat_batches"])),
            retry_policy=RetryPolicy(attempts=score_retries) if score_retries > 0 else None,
            attribute_anchors=bool(ev["attribute_anchors"]),
            expected_reports=spec["end"] - spec["start"],
        )
        # the completion marker commits after the journal drained
        atomic_write_text(
            shard_dir / "shard_metrics.json",
            json.dumps({"shard": spec["name"], "span": [spec["start"], spec["end"]],
                        "rows": metrics.get("num_samples", 0), "metrics": metrics}, default=str),
        )
        return 0
    finally:
        _record_device_counts(tel, device)
        tel.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        # CLI usage text belongs on stderr, not in a logger
        print(  # lint: disable=MV101
            "usage: python -m memvul_tpu_torch.distributed.worker <spec.json>", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return run_worker(argv[0])


if __name__ == "__main__":
    sys.exit(main())
