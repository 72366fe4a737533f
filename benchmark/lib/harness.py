"""One run of one cell: set up, measure for ``--seconds``, check, report.

The command (``run.py``) refuses to run without enough cards and then calls
:func:`run_cell` on ``cuda``; the tests call it on the CPU.  A run:

1. on a cell of several cards, starts ranks 1..n-1 (:mod:`.world`) and
   joins the world as a ``data`` mesh of the program, with a gloo group on
   the host for the harness's own agreements;
2. sets the cell up through its entry (``setup``), then, every rank ready,
   opens the window; ``setup_s`` is the time from the process's start;
3. measures (``measure``): with ``--trace 1`` under ``torch.profiler``,
   the window inside a ``perfbench.window`` range;
4. reads the peak device memory, gathers each rank's trace summary, frees
   the program's state (``release``) and lets ranks 1..n-1 go;
5. on rank 0, compares what the window produced with the reference
   (``check``), reads the cell's metrics through their readers, refuses a
   process that holds JAX or the JAX package, and prints the result as its
   last line, each compared number beside its limit at the end of standard
   error and under ``checks`` as the line's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import manifest, trace, world

FORBIDDEN = ("jax", "jaxlib", "flax", "memvul_tpu")


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = manifest.ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / "perfbench-cache" / sub)
    # keep libraries that can load JAX on their own from doing so
    os.environ.update(USE_FLAX="0", USE_TF="0", USE_JAX="0")


class Tracer:
    """``torch.profiler`` over the window, or nothing (``--trace 0``)."""

    def __init__(self, enabled: bool, device) -> None:
        self.enabled = enabled
        self.device = device
        self.active = False
        self.prof = None
        self._window = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self._window = record_function(trace.WINDOW)
        self._window.__enter__()
        self.active = True

    def range(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.autograd.profiler import record_function

        return record_function(name)

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        self._window.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.active = False

    def collected(self) -> Optional[Dict]:
        return trace.collect(self.prof) if self.prof is not None else None


@dataclass
class Context:
    """What an entry is given."""

    workload: Dict
    config: Dict
    traffic: Dict
    cell: Dict
    reference: Any
    seed: int
    seconds: float
    device: Any
    chips: int
    mesh: Any = None
    host_group: Any = None
    rank: int = 0
    tracer: Tracer = None
    overrides: Dict = field(default_factory=dict)


def _mesh_max(value: float, mesh) -> float:
    if mesh is None:
        return value
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _gather(obj, mesh) -> List:
    if mesh is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj)
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def join(chips: int, device: str, argv: List[str]):
    """(mesh or None, host group or None, device, the started ranks or None)
    for a cell of ``chips`` cards: rank 0 starts ranks 1..n-1 as
    ``python <argv>``.  The host group, gloo over the same world, carries
    the harness's agreements inside the window, so they add no kernel and
    no device sync there."""
    import torch

    if chips == 1:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        return None, None, dev, None
    world.watch_parent()
    ranks = world.World.start(argv, chips) if world.rank() == 0 else None
    import torch.distributed as dist
    from memvul_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"data": chips}, device=device, timeout_s=300.0)
    return mesh, dist.new_group(backend="gloo"), mesh.device, ranks


def leave(ranks, ok: bool) -> bool:
    """Wait for (or, unless ``ok``, kill) the started ranks; True when every
    rank ended well.  The process group is not torn down: a rank that has
    made its last collective ends its process without the interpreter's
    teardown (``run.py``), where NCCL's can wait on peers that are gone."""
    return ranks.close(ok=ok) if ranks is not None else ok


def context(workload: str, seed: int, seconds: float, trace_on: bool, dev, mesh, host_group,
            overrides: Optional[Dict] = None) -> Context:
    w = manifest.workload(workload)
    cfg = manifest.config(w["config"])
    return Context(workload=w, config=cfg, traffic=manifest.traffic(w["traffic"]),
                   cell=manifest.cell(workload), reference=manifest.reference(cfg["reference"]),
                   seed=seed, seconds=seconds, device=dev, chips=int(w["chips"]), mesh=mesh,
                   host_group=host_group, rank=world.rank(), tracer=Tracer(trace_on, dev), overrides=overrides or {})


def run_cell(args: argparse.Namespace, device: str, t_start: float,
             argv: Optional[List[str]] = None) -> int:
    """Run one cell on ``device`` ("cuda" or, in tests, "cpu"); returns the
    exit code.  Only rank 0 prints a result."""
    import torch

    chips = int(manifest.workload(args.workload)["chips"])
    mesh, host_group, dev, ranks = join(chips, device,
                                        [sys.argv[0], *(argv if argv is not None else sys.argv[1:])])
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace), dev, mesh, host_group)
    entry = manifest.entry(ctx.traffic["entry"])
    try:
        state = entry.setup(ctx)
        _mesh_max(0.0, mesh)  # every rank ready
        setup_s = time.perf_counter() - t_start
        run = entry.measure(ctx, state)
        peak = 0
        if dev.type == "cuda":
            peak = int(_mesh_max(torch.cuda.max_memory_allocated(dev), mesh))
        collected = ctx.tracer.collected()
        summary = trace.summarize(collected) if collected is not None else None
        summaries = _gather(summary, mesh) if args.trace else None
        entry.release(ctx, state)
        if ctx.rank != 0:
            return 0
        verdict = entry.check(ctx, run)
        run.update(setup_s=setup_s, chips=chips, trace=collected, ranks=summaries,
                   cell=args.workload, config=ctx.config)
        metrics = {}
        for m in manifest.metrics_for(args.workload, bool(args.trace)):
            value = manifest.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        good = leave(ranks, ok=True)
        ranks = None
        if not good:
            return 1
        found = forbidden_modules()
        if found:
            sys.stderr.write(f"refused: the process holds {', '.join(found)}\n")
            return 3
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                       "count": chips, "memory_peak_bytes": peak}
        result = {"correct": verdict["correct"], "attempted": verdict["attempted"],
                  "failed": verdict["failed"], "metrics": metrics, "device": device_info}
        if args.trace:
            for i, s in enumerate(summaries):
                print(json.dumps({"rank": i, "busy_s": s["busy_s"], "window_s": s["window_s"],
                                  "device_idle": 1.0 - s["busy_s"] / s["window_s"]}))
            device_info["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
            device_info["window_s"] = sum(s["window_s"] for s in summaries) / len(summaries)
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = verdict["checks"]
        for name, c in verdict["checks"].items():
            sys.stderr.write(f"check {name}: {c['value']!r} (limit {c['limit']!r})\n")
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        if ranks is not None:
            leave(ranks, ok=False)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    w = manifest.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"{args.workload} needs {w['chips']} CUDA card(s); this host has {have}\n")
        return 2
    return run_cell(args, "cuda", t_start, argv=argv)
