"""One traced run of a cell with the program's span recorder on: where the
card's idle time goes, by the program's own spans.

    python3 benchmark/tools/span_view.py --workload W --seed N --seconds S

The run is the benchmark's traced run (``run.py --trace 1``) with two
additions: the program records its spans (``memvul_tpu_torch.telemetry.
spans``) from before set-up to the end of the window, and the tracer reads
the clock pair that puts them on the profiler's clock (``lib/spans.py``).
The last line of standard output is one JSON object: ``setup_s``, the
cell's per-layer metrics beside the five that read the program's spans and
counters (``h2d_block.score``, ``launch_self.score``, ``feed_busy.score``,
``pad_share.score``, ``setup_program_s.score``), the device's busy and
window seconds, the spans kept and dropped, and the idle-by-span table,
which also goes to standard error.  The answers are not compared: ``run.py``
does that.  The benchmark's own runs never run this.  On a cell of several
cards every rank runs it; rank 0 prints.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import harness, manifest, spans, trace  # noqa: E402

SPAN_METRICS = ("h2d_block.score", "launch_self.score", "feed_busy.score", "pad_share.score",
                "setup_program_s.score")


def main(argv, device: str = "cuda", t_start: float = T_START) -> int:
    p = argparse.ArgumentParser(prog="benchmark/tools/span_view.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from memvul_tpu_torch.telemetry import spans as recorder

    harness.cache_dirs()
    chips = int(manifest.workload(args.workload)["chips"])
    mesh, host_group, dev, ranks = harness.join(chips, device, [sys.argv[0], *argv])
    ok = False
    try:
        ctx = harness.context(args.workload, args.seed, args.seconds, True, dev, mesh, host_group)
        ctx.tracer = spans.SpanTracer(True, dev)
        entry = manifest.entry(ctx.traffic["entry"])
        recorder.record(True)
        state = entry.setup(ctx)
        harness._mesh_max(0.0, mesh)  # every rank ready
        setup_s = time.perf_counter() - t_start
        run = entry.measure(ctx, state)
        recorder.record(False)
        counters = state["predictor"].telemetry.snapshot()["counters"]
        collected = ctx.tracer.collected()
        summaries = harness._gather(trace.summarize(collected), mesh)
        entry.release(ctx, state)
        run.pop("state")
        ok = True
        if ctx.rank != 0:
            return 0
        run.update(setup_s=setup_s, chips=chips, trace=collected, ranks=summaries,
                   cell=args.workload, config=ctx.config,
                   program=spans.program_view(recorder.recorded(), counters, recorder.dropped(),
                                              collected["clock"]))
        metrics = {}
        for name in [m["name"] for m in manifest.metrics_for(args.workload, True)] + list(SPAN_METRICS):
            value = manifest.reader(name).read(run)
            if value is not None:
                metrics[name] = value
        table = spans.idle_by_span(run)
        if table is not None:
            sys.stderr.write(spans.format_table(table) + "\n")
            sys.stderr.flush()
        print(json.dumps({"workload": args.workload, "seed": args.seed, "setup_s": setup_s,
                          "metrics": metrics, "busy_s": summaries[0]["busy_s"],
                          "window_s": summaries[0]["window_s"],
                          "spans": len(run["program"]["spans"]), "dropped": recorder.dropped(),
                          "idle_by_span": table}), flush=True)
        return 0
    finally:
        harness.leave(ranks, ok=ok)


if __name__ == "__main__":
    code = main(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
