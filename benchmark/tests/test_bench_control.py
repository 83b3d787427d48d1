"""The control, the float32 reference in the program's place, comes out
as not correct through the harness's own check; the exact reference in
the same place comes out correct."""

import torch

from bench_cases import traffic
from harness import cell
from harness.control import ControlEntry


def _run(dtype, workload="cd16.track.device"):
    # Long enough for loud passages: the float32 sums round there.
    tr = dict(traffic(workload), pool=2)
    tr["lengths_s"] = dict(tr["lengths_s"], lo=10, hi=20)
    return cell.run_cell(workload, 2024, 0.2, False, device="cpu",
                         traffic=tr, entry=ControlEntry(dtype))[0]


def test_float32_control_fails():
    res = _run(torch.float32)
    assert res["correct"] is False
    assert res["checks"]["wrong_samples"]["value"] > 0


def test_exact_reference_in_the_same_place_passes():
    res = _run(torch.int64)
    assert res["correct"] is True
    assert res["checks"]["wrong_samples"]["value"] == 0
