"""The readings a cell's comparison limits are set from, in one process.

    python3 benchmark/tools/readings.py --workload W --seconds S \
        --seeds 1,2,3 --control-seeds 4,5,6

For each seed it sets the cell up, runs a short window at the cell's own
load and compares the answers with the reference, as a run does: first the
program as the configuration states it, then the control, the same program
with its int8 tier switched on (``model.encoder.quant = "int8"``: the six
projections of every layer contract in int8), the nearest precision below
the configuration's bf16; the control's answers that come back after the
window count too, since its path is slower.  Each reading is one JSON line:
``answer_mse``, the number the cell's limit holds, the worst sampled
answer's error, the answers compared, the reports back in the window and
the count not returned exactly once; ``--dump`` keeps each reading's
answers.  The benchmark's own runs never run this.  On a cell of several
cards every rank runs it; rank 0 prints.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from benchmark.lib import harness, manifest  # noqa: E402

CONTROL = {"model": {"encoder": {"quant": "int8"}}}


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--dump", default="", help="a directory for each reading's answers (.npz)")
    args = p.parse_args(argv)
    harness.cache_dirs()
    chips = int(manifest.workload(args.workload)["chips"])
    mesh, host_group, dev, ranks = harness.join(chips, "cuda", [sys.argv[0], *argv])
    ok = False
    try:
        plan = [("program", s, {}) for s in args.seeds.split(",") if s] + \
               [("control", s, CONTROL) for s in args.control_seeds.split(",") if s]
        for variant, seed, overrides in plan:
            t0 = time.perf_counter()
            ctx = harness.context(args.workload, int(seed), args.seconds, False, dev, mesh,
                                  host_group, overrides)
            entry = manifest.entry(ctx.traffic["entry"])
            state = entry.setup(ctx)
            run = entry.measure(ctx, state)
            entry.release(ctx, state)
            if ctx.rank != 0:
                continue
            if variant == "control":
                # what its slower path finished after the window counts too
                run["t_end"] = float("inf")
            verdict = entry.check(ctx, run)
            err = verdict["errors"]
            if args.dump:
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                np.savez(Path(args.dump) / f"{variant}-{seed}.npz", errors=err,
                         **verdict["answers"])
            print(json.dumps({
                "variant": variant, "seed": int(seed), "correct": verdict["correct"],
                "answer_mse": float(err.mean()) if err.size else None,
                "worst_answer": float(err.max()) if err.size else None,
                "answers": int(err.size), "reports": run["reports"],
                "missing_or_repeated": verdict["checks"]["missing_or_repeated"]["value"],
                "seconds": time.perf_counter() - t0}), flush=True)
        ok = True
        return 0
    finally:
        harness.leave(ranks, ok=ok)


if __name__ == "__main__":
    import os

    code = main(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
