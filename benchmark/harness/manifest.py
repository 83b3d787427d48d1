"""BENCHMARK.json and the files each of its names resolves to.

Everything that belongs to one configuration, traffic mix, entry,
per-layer metric or kernel sits in a file of its own under the
benchmark's folder, found by its name:

    configs/<config>.json    traffic/<traffic>.json    entries/<entry>.py
    metrics/<metric>.py      roofline/<kernel>.py
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


_MODULES = {}


def module(kind: str, name: str):
    """The module of file <kind>/<name>.py (entries, metrics or
    roofline), loaded once."""
    key = (kind, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those that list no cells and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]
