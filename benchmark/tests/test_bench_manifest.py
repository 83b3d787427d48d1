"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its file."""

import json
import os
import re

import pytest

from harness import manifest
from bench_cases import CELLS

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH = manifest.load()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_fits_its_budget_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
        assert len(c["reduced"]) <= 16


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
    for cell in CELLS:
        assert manifest.per_layer(BENCH, cell), cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    w = manifest.cell(BENCH, cell)
    cfg = manifest.config(w["config"])
    assert cfg["name"] == w["config"]
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    assert os.path.isfile(os.path.join(manifest.ROOT, conf["file"]))
    assert conf["reduced"] == cfg["reduced"]
    tr = manifest.traffic(w["traffic"])
    entry = manifest.module("entries", tr["entry"])
    for attr in ("call", "stats", "capture", "pcm", "SPANS", "NORMALIZED"):
        assert hasattr(entry, attr), attr
    for m in manifest.per_layer(BENCH, cell):
        reader = manifest.module("metrics", m["name"])
        assert callable(reader.read)
        if m["name"].endswith("_roofline") and m["name"] != "device_roofline":
            kernel = m["name"][:-len("_roofline")]
            rf = manifest.module("roofline", kernel)
            assert rf.KERNEL and callable(rf.work)
    e2e = [m["name"] for m in manifest.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
