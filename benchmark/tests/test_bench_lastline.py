"""The result line: its keys, its metrics, the checks last; and the
command's refusal to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from bench_cases import CELLS, traffic
from harness import cell, manifest

ROOT = manifest.ROOT


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_keys(workload):
    res, lines = cell.run_cell(workload, 2**31 + 5, 0.3, False, device="cpu",
                               traffic=traffic(workload))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    bench = manifest.load()
    assert list(res["metrics"]) == [m["name"] for m in
                                    manifest.end_to_end(bench, workload)]
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            name == "peak_device_mib"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert lines[-2:] == ["wrong_samples 0 limit 0", "failed_calls 0 limit 0"]
    json.dumps(res)


def test_traced_line_has_per_layer_metrics_and_breakdown():
    wl = "cd16.track.host"
    res, _ = cell.run_cell(wl, 7, 0.3, True, device="cpu", traffic=traffic(wl))
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = {m["name"] for m in manifest.per_layer(manifest.load(), wl)}
    assert set(res["metrics"]) <= names
    assert {"rows.plan_ms", "rows.reconstruct_ms", "rows.finish_ms"} <= set(
        res["metrics"])
    assert all(len(b) <= 10 for b in res["breakdown"].values())


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cd16.track.device", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
