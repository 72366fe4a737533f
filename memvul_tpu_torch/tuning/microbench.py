"""Seeded in-process microbenches for tune candidates (the JAX package's
``tuning/microbench.py``).

One :class:`TuneBench` builds the expensive shared state ONCE — the
synthetic workspace, the model and its seeded weights, the probe texts
and the anchor set — and then scores candidates with the same primitives
the standalone ``BENCH_MICRO=train_step`` / ``serve`` harnesses use
(:mod:`memvul_tpu_torch.bench`), just smaller and callable in-process:

* :meth:`bench_train` — one warmup epoch + one timed epoch over the
  identical seeded pair stream per candidate, returning the trainer's own
  epoch metrics (real/padded token throughput);
* :meth:`bench_serve` — a closed-loop client pool over a fixed text
  schedule through a :class:`ScoringService` built with the candidate's
  dispatch knobs, returning rps + latency percentiles + the padding
  ledger from the leg's private telemetry registry;
* :meth:`probe_scores` / :meth:`train_losses` — the parity gate's
  evidence: scores on a fixed probe set, and the per-step loss
  trajectory of one short deterministic epoch.

Everything is seeded (workspace seed, reader seed, weight seed, the
trainer's dropout generator); two calls with the same knobs produce the
same stream, which is what lets the parity gate demand bitwise equality
for layout-only candidates.  The model holds its weights, so every
trainer gets a fresh copy of the seeded CPU master (a train step updates
its model in place); the serving candidates share one read-only copy on
the device.
"""

from __future__ import annotations

import copy
import logging
import queue as _queue
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Union

logger = logging.getLogger(__name__)

# the fixed probe set size for parity evidence; small because every
# serving candidate pays one probe pass through BOTH layouts
DEFAULT_PROBE = 32


class TuneBench:
    """Shared microbench state + per-candidate runners on ``device``.

    ``model_size`` follows the bench harness contract: ``"tiny"``
    exercises every code path in seconds (the CPU harness record),
    ``"base"`` is the geometry that means something on the card.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        model_size: str = "tiny",
        seq_len: int = 128,
        batch_size: int = 8,
        grad_accum: int = 1,
        steps_per_epoch: int = 4,
        reports_per_project: int = 48,
        n_requests: int = 96,
        n_clients: int = 4,
        max_batch: int = 8,
        probe_size: int = DEFAULT_PROBE,
        workdir: Optional[str] = None,
        device: Union[str, Any] = "cuda",
    ) -> None:
        from ..bench import _anchor_instances, bench_model
        from ..utils.platform import resolve_device
        from ..data.readers import MemoryReader
        from ..data.synthetic import build_workspace

        self.device = resolve_device(device)
        self.seed = int(seed)
        self.model_size = model_size
        self.batch_size = int(batch_size)
        self.grad_accum = int(grad_accum)
        self.steps_per_epoch = int(steps_per_epoch)
        self.n_requests = int(n_requests)
        self.n_clients = int(n_clients)
        self.max_batch = int(max_batch)
        self._workdir = workdir or tempfile.mkdtemp(prefix="memvul-tune-")
        self.workspace = build_workspace(
            self._workdir, seed=self.seed, num_projects=8,
            reports_per_project=int(reports_per_project),
            realistic_lengths=True,
        )
        self.model, self.seq_len = bench_model(
            self.workspace["tokenizer"].vocab_size, model_size, seq_len)
        self.buckets = tuple(
            b for b in (64, 128, 256, 512) if b <= self.seq_len
        ) or (self.seq_len,)
        self._serve_model = None

        reader = MemoryReader(
            cve_path=self.workspace["paths"]["cve"],
            anchor_path=self.workspace["paths"]["anchors"],
        )
        instances = list(
            reader.read(self.workspace["paths"]["test"], split="test")
        )
        # the labeled golden set: the cascade band chooser and any
        # cross-impl evaluate_gate check score these, metas included
        self.golden_instances: List[Dict[str, Any]] = instances
        texts = [inst["text1"] for inst in instances]
        while len(texts) < max(self.n_requests, probe_size):
            texts = texts + texts
        self.texts: List[str] = texts[: self.n_requests]
        self.probe_texts: List[str] = texts[: int(probe_size)]
        self.anchor_instances = _anchor_instances(self.workspace, 33)

    # -- training ---------------------------------------------------------------

    def _make_trainer(self, knobs: Dict[str, Any]):
        from ..data.readers import MemoryReader
        from ..training.trainer import MemoryTrainer, TrainerConfig

        reader = MemoryReader(
            cve_path=self.workspace["paths"]["cve"],
            anchor_path=self.workspace["paths"]["anchors"],
            sample_neg=0.5, seed=2021,
        )
        cfg_kw = {
            k: knobs[k]
            for k in ("train_buckets", "dedup_anchors", "prefetch_depth")
            if k in knobs
        }
        return MemoryTrainer(
            # a fresh copy of the seeded weights per candidate: the
            # trainer updates its model in place
            copy.deepcopy(self.model),
            self.workspace["tokenizer"], reader,
            train_path=self.workspace["paths"]["train"],
            config=TrainerConfig(
                batch_size=self.batch_size, grad_accum=self.grad_accum,
                max_length=self.seq_len,
                steps_per_epoch=self.steps_per_epoch, num_epochs=1,
                warmup_steps=1, serialization_dir=None,
                **cfg_kw,
            ),
            device=self.device,
        )

    def bench_train(self, knobs: Dict[str, Any],
                    with_losses: bool = False) -> Dict[str, Any]:
        """Warmup epoch (first call of every stack shape) + one timed
        epoch over the identical epoch-0 stream, per the train_step harness
        contract.  ``with_losses=True`` also returns the WARMUP epoch's
        per-step loss trajectory (the parity gate's training evidence —
        epoch 0 from fresh weights, the same stream every candidate
        sees) without paying a third epoch."""
        from ..bench import step_shapes

        trainer = self._make_trainer(knobs)
        warm = trainer.train_epoch()
        m = trainer.train_epoch()  # timed: the same epoch-0 stream
        out = {
            "epoch_s": round(m["epoch_seconds"], 4),
            "steps": m["num_steps"],
            "padded_tokens": m["padded_tokens"],
            "real_tokens": m["real_tokens"],
            "padded_tokens_per_s": round(m["tokens_per_sec"], 1),
            "real_tokens_per_s": round(m["real_tokens_per_sec"], 1),
            "compiled_step_shapes": len(step_shapes(trainer)),
        }
        if with_losses:
            out["losses"] = list(warm["losses"])
        return out

    def train_losses(self, knobs: Dict[str, Any]) -> List[float]:
        """The per-step loss trajectory of ONE deterministic epoch —
        the training side of the parity gate's probe evidence, when the
        caller wants it without a full bench."""
        return list(self._make_trainer(knobs).train_epoch()["losses"])

    # -- serving ----------------------------------------------------------------

    def serve_model(self):
        """The weights the serving candidates share: one eval-mode copy on
        the device."""
        if self._serve_model is None:
            self._serve_model = copy.deepcopy(self.model).to(self.device).eval()
        return self._serve_model

    def build_predictor(self, knobs: Dict[str, Any], *,
                        encoder_precision: str = "fp32"):
        """A :class:`SiamesePredictor` wired for one serve candidate,
        anchors encoded (so it is immediately scoreable)."""
        from ..evaluate.predict_memory import SiamesePredictor

        impl = knobs.get("score_impl", "bucketed")
        kwargs: Dict[str, Any] = {}
        if impl in ("ragged", "continuous"):
            kwargs = dict(
                score_impl=impl,
                token_budget=int(
                    knobs.get("token_budget") or 4 * self.seq_len
                ),
                max_rows_per_pack=int(
                    knobs.get("max_rows_per_pack")
                    or knobs.get("max_batch", self.max_batch)
                ),
            )
        elif impl == "cascade":
            kwargs = dict(
                score_impl="cascade", encoder_precision="int8",
                cascade_low=float(knobs.get("cascade_low", 0.3)),
                cascade_high=float(knobs.get("cascade_high", 0.7)),
            )
        if encoder_precision != "fp32" and "encoder_precision" not in kwargs:
            kwargs["encoder_precision"] = encoder_precision
        predictor = SiamesePredictor(
            self.serve_model(), self.workspace["tokenizer"],
            batch_size=int(knobs.get("max_batch", self.max_batch)),
            max_length=self.seq_len, buckets=self.buckets,
            **kwargs,
        )
        predictor.encode_anchors(self.anchor_instances)
        return predictor

    def bench_serve(self, knobs: Dict[str, Any]) -> Dict[str, Any]:
        """One closed-loop leg (the serve harness's ``_drive_leg``
        shape): ``n_clients`` threads drain a shared queue of the fixed
        text schedule through an :class:`InprocessClient`, deadlines
        off.  Returns rps, latency percentiles, and the padding
        ledger from the leg's own registry."""
        import numpy as np

        from ..serving import InprocessClient, ScoringService, ServiceConfig
        from ..telemetry import Registry

        registry = Registry()
        predictor = self.build_predictor(knobs)
        max_batch = int(knobs.get("max_batch", self.max_batch))
        service = ScoringService(
            predictor,
            config=ServiceConfig(
                max_batch=max_batch,
                max_wait_ms=float(knobs.get("max_wait_ms", 5.0)),
                max_queue=max(256, 2 * self.n_clients * max_batch),
                default_deadline_ms=0.0,
            ),
            registry=registry,
        )
        client = InprocessClient(service)
        work: "_queue.SimpleQueue" = _queue.SimpleQueue()
        for text in self.texts:
            work.put(text)
        latencies: List[float] = []
        lat_lock = threading.Lock()
        errors = [0]

        def _client_loop() -> None:
            own: List[float] = []
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

        client.score(self.texts[0], deadline_ms=0)  # warmup trickle
        threads = [
            threading.Thread(target=_client_loop, daemon=True)
            for _ in range(self.n_clients)
        ]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - start
        service.drain()
        counters = registry.snapshot()["counters"]
        lat_ms = np.sort(np.asarray(latencies)) * 1e3
        pct = (
            lambda q: round(float(np.percentile(lat_ms, q)), 3)
            if len(lat_ms) else None
        )
        return {
            "requests_per_sec": round(len(self.texts) / elapsed, 1),
            "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99)},
            "errors": errors[0],
            "real_tokens": int(counters.get("serve.tokens_real", 0)),
            "padded_tokens": int(counters.get("serve.tokens_padded", 0)),
        }

    def probe_scores(self, knobs: Dict[str, Any], *,
                     impl: Optional[str] = None):
        """Scores of the fixed probe set through one candidate's
        predictor — the serving side of the parity gate's evidence.
        ``impl`` passes through to ``score_texts`` (``"int8"`` is the
        cascade band chooser's distribution input)."""
        predictor = self.build_predictor(
            knobs,
            encoder_precision="int8" if impl in ("int8", "cascade") else "fp32",
        )
        return predictor.score_texts(self.probe_texts, impl=impl)
