"""On the card: the cell's program passes its comparison and the control
(the program's int8 tier) fails it, at the cell's own size.  Run on a card
with ``python -m pytest benchmark/tests -q -m card``; on the CPU it skips."""

import json
import subprocess
import sys

import pytest

from benchmark.lib import manifest

TOOL = manifest.HERE / "tools" / "readings.py"


@pytest.mark.card
@pytest.mark.parametrize("workload", ["score.longctx.long", "score.base.corpus"])
def test_program_passes_and_control_fails(card, workload):
    proc = subprocess.run([sys.executable, str(TOOL), "--workload", workload, "--seconds", "8",
                           "--seeds", "101,102", "--control-seeds", "201,202"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    limit = manifest.cell(workload)["limits"]["answer_mse"]
    program = [r for r in rows if r["variant"] == "program"]
    control = [r for r in rows if r["variant"] == "control"]
    assert len(program) == len(control) == 2
    assert all(r["correct"] and r["answer_mse"] <= limit for r in program)
    # the control answers, and its answers are judged wrong
    assert all(r["answers"] > 0 and r["answer_mse"] > limit and not r["correct"] for r in control)
