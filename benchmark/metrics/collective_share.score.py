"""Share of rank 0's traced window in which an NCCL kernel ran on its card:
the program's per-batch gather of the answers (the harness agrees over gloo
on the host, and adds none)."""

from benchmark.lib import trace as tr


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    lo, hi = trace["window"]
    nccl = [x for x in trace["device"] if "nccl" in x[0].lower()]
    if not nccl:
        return None
    return 100.0 * tr.seconds(tr.busy_intervals(nccl, lo, hi)) / ((hi - lo) / 1e9)
