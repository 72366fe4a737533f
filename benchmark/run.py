"""The benchmark of memvul_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are found by name from
``BENCHMARK.json`` and the files under ``benchmark/`` (``lib/manifest.py``).
The last line of standard output is the result as one JSON object.  Without
as many CUDA cards as the cell asks for, the command exits 2 and prints no
result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_dirs()
    code = harness.main(sys.argv[1:], T_START)
    sys.stdout.flush()
    sys.stderr.flush()
    # every process this run started has ended; skip the interpreter's
    # teardown, where a process group's can wait on ranks that are gone
    os._exit(code)
