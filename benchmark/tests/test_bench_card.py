"""One short run of each cell on the card, from the command line, as the
check runs it. Needs a CUDA card: skips without one."""

import json
import subprocess
import sys

import pytest
import torch

from bench_cases import CELLS
from harness import manifest


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
