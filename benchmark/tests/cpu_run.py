"""A run of a cell on the CPU, for the tests: ``run.py``'s command without
its look for a card, with an optional fault planted in the program first.

    python benchmark/tests/cpu_run.py --workload W --seed N --seconds S --trace T

``PERFBENCH_FAULT`` names the fault: ``answer_swapped`` (each batch's
answers rolled by one row), ``half_batch`` (the second half of each batch's
rows replaced by the mean of the first half's), ``answer_shifted`` (every
answer's logit shifted by one constant, half the first batch's spread
between reports: a wrong bias) or ``no_exchange`` (the gather between ranks
left out: each rank keeps only its own rows).
``PERFBENCH_MODULES_OUT`` names a file that receives, after the run, the
top-level names of every module the process loaded.
"""

import json
import os
import sys
import time

T_START = time.perf_counter()
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

from benchmark.lib import harness  # noqa: E402


def plant(fault: str) -> None:
    from memvul_tpu_torch.evaluate import predict_memory

    score = predict_memory.SiamesePredictor._score

    if fault == "answer_swapped":
        def broken(self, block, bank=None, model=None):
            return score(self, block, bank, model).roll(1, dims=0)
    elif fault == "half_batch":
        def broken(self, block, bank=None, model=None):
            out = score(self, block, bank, model).clone()
            half = out.shape[0] // 2
            out[half:] = out[:half].mean(dim=0, keepdim=True)
            return out
    elif fault == "answer_shifted":
        shift = []

        def broken(self, block, bank=None, model=None):
            p = score(self, block, bank, model)
            z = torch.logit(p.double(), eps=1e-7)
            spread = float(z.std(dim=0).mean()) if z.shape[0] > 1 else 0.0
            if not shift and spread > 0:  # the warm-up's rows are alike
                shift.append(0.5 * spread)
            return torch.sigmoid(z + (shift[0] if shift else 0.0)).to(p.dtype)
    elif fault == "no_exchange":
        from memvul_tpu_torch.parallel.mesh import DATA_AXIS

        def gather(local, mesh):
            d = mesh.size(DATA_AXIS)
            buf = local.new_zeros((d * local.shape[0],) + tuple(local.shape[1:]))
            i = mesh.index(DATA_AXIS)
            buf[i * local.shape[0] : (i + 1) * local.shape[0]] = local
            return buf

        predict_memory.gather_blocks = gather
        return
    else:
        raise ValueError(f"unknown fault {fault!r}")
    predict_memory.SiamesePredictor._score = broken


if __name__ == "__main__":
    torch.set_num_threads(2)
    if os.environ.get("PERFBENCH_FAULT"):
        plant(os.environ["PERFBENCH_FAULT"])
    args = harness.parse(sys.argv[1:])
    code = harness.run_cell(args, "cpu", T_START, argv=sys.argv[1:])
    if os.environ.get("PERFBENCH_MODULES_OUT"):
        tops = sorted({name.split(".", 1)[0] for name in list(sys.modules)})
        Path(os.environ["PERFBENCH_MODULES_OUT"]).write_text(json.dumps(tops))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
