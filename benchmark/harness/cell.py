"""One run of one cell: make the inputs, warm up, measure a closed loop
for the window, check the outputs against the reference, and build the
result line.

A call's time is the host clock around the entry's call, which returns
once the PCM is usable (entries/<entry>.py). The loop has one client:
it sends the next stream when the last has come back, in rounds through
the pool in an order drawn from the seed. For each stream one
occurrence, drawn from the seed among its first few, is checked: its
output is copied to the host right after its call's time has been
taken, and compared with the reference once the window has closed and
the peak of device memory has been read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import manifest, pool, reference, trace as trace_mod



@dataclass
class Call:
    item: int
    ms: float
    ok: bool
    in_window: bool
    stats: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a run saw, as the per-layer readers (metrics/<name>.py)
    take it."""
    workload: str
    config: dict
    traffic: dict
    items: list
    calls: list
    window_s: float
    spans: dict                 # span name -> summed seconds in the window
    trace: trace_mod.Trace | None

    def window_calls(self) -> list:
        """The calls of the window that returned an answer."""
        return [c for c in self.calls if c.in_window and c.ok]


class _Spans:
    """The traced run's spans: `record_function` ranges for the
    profiler, and host-clock sums while `active`."""

    def __init__(self):
        self.active = False
        self.total = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if self.active:
            self.total[name] = self.total.get(name, 0.0) + (
                time.perf_counter() - t)

    def wrap(self, spans) -> list:
        """Wrap each (module, attribute, span name) of the program in a
        span; returns what restores them."""
        undo = []
        for mod_name, attr, name in spans:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=name, **k):
                with self(_name):
                    return _fn(*a, **k)

            setattr(mod, attr, wrapped)
            undo.append((mod, attr, fn))
        return undo


def _no_span(name):
    return contextlib.nullcontext()


def _percentile(ms: list, q: float) -> float:
    return float(np.percentile(np.asarray(ms, dtype=np.float64), q))


def _window(entry, items, sched, device, seconds: float, span,
            spans: _Spans | None):
    """The closed loop. Returns (calls, captured outputs by stream,
    window seconds, window start and end in epoch ns)."""
    calls, captured, seen = [], {}, [0] * len(items)
    extra = 0
    t_start, t0_ns = time.perf_counter(), time.time_ns()
    t_end, t1_ns = t_start, t0_ns
    deadline = t_start + seconds
    while True:
        in_window = time.perf_counter() < deadline
        if not in_window:
            if spans is not None:
                spans.active = False
            # Past the window only to reach an unchecked stream's turn.
            if len(captured) == len(items) or extra >= 4 * len(items):
                break
            extra += 1
        j = sched.next()
        t = time.perf_counter()
        try:
            with span("call"):
                res = entry.call(items[j].data, device, span)
            ok = res is not None
        except Exception as exc:      # a failed call is counted, not fatal
            res, ok = None, False
            print(f"call on stream {j} failed: {exc!r}", file=sys.stderr,
                  flush=True)
        ms = (time.perf_counter() - t) * 1e3
        if in_window:
            t_end, t1_ns = time.perf_counter(), time.time_ns()
        calls.append(Call(j, ms, ok, in_window,
                          entry.stats(res) if ok else {}))
        if ok and j not in captured and seen[j] >= sched.check_at[j]:
            captured[j] = entry.capture(res)
        seen[j] += 1
        del res
    return calls, captured, t_end - t_start, t0_ns, t1_ns


def compare(entry, items, captured, config, device, dtype=torch.int64):
    """Samples of the checked outputs that differ from the reference,
    with every sample of a stream whose output never came counted.
    Returns (wrong samples, checked streams)."""
    C = config["format"]["channels"]
    bps = config["format"]["bits_per_sample"]
    order = sorted(captured)
    refs = reference.decode([items[j].side for j in order], C, device,
                            dtype) if order else []
    wrong = sum(items[j].samples for j in range(len(items))
                if j not in captured)
    for j, ref in zip(order, refs):
        if dtype == torch.int64 and not np.array_equal(ref, items[j].pcm):
            raise RuntimeError(f"stream {j}: the benchmark's reference does "
                               "not give back the PCM its encoder was given")
        want = reference.output_domain(ref, bps, entry.NORMALIZED)
        try:
            got = entry.pcm(captured[j], C)
        except ValueError:
            wrong += want.size
            continue
        n = min(len(got), len(want))
        wrong += int((got[:n] != want[:n]).sum())
        wrong += abs(len(got) - len(want)) * C
    return wrong, len(order)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t0: float | None = None, bench=None,
             config=None, traffic=None, entry=None) -> tuple:
    """One run of cell `workload`. `config`, `traffic` and `entry`
    replace the cell's own (tests, the control). Returns (result dict,
    the check lines for standard error)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or manifest.load()
    cell = manifest.cell(bench, workload)
    config = config or manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    entry = entry or manifest.module("entries", traffic["entry"])
    cuda = torch.device(device).type == "cuda"

    t_pool = time.perf_counter()
    items = pool.build(config, traffic, seed, device)
    t_warm = time.perf_counter()
    if hasattr(entry, "prepare"):
        entry.prepare(items, config, device)
    for j, it in enumerate(items):         # warm-up: every stream once
        try:
            entry.call(it.data, device, _no_span)
        except Exception as exc:      # the window's calls count it
            print(f"warm-up call on stream {j} failed: {exc!r}",
                  file=sys.stderr, flush=True)
    gc.collect()
    # The set-up's objects are never garbage: keep the collector off them.
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    spans = _Spans() if traced else None
    undo = spans.wrap(entry.SPANS) if traced else []
    sched = pool.Schedule(seed, len(items), traffic["check_within_first"])
    prof = None
    setup_s = time.perf_counter() - t0
    try:
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts, record_shapes=True)
            prof.__enter__()
            spans.active = True
        calls, captured, window_s, t0_ns, t1_ns = _window(
            entry, items, sched, device, seconds,
            spans if traced else _no_span, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    tr = trace_mod.reduce(prof, t0_ns, t1_ns) if prof is not None else None
    del prof

    wrong, checked = compare(entry, items, captured, config, device)
    win = [c for c in calls if c.in_window]
    failed = sum(not c.ok for c in win)
    run = Run(workload, config, traffic, items, calls, window_s,
              dict(spans.total) if spans else {}, tr)

    metrics = {}
    if traced:
        for m in manifest.per_layer(bench, workload):
            v = manifest.module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        done = run.window_calls()
        values = {
            "msamples_per_s": sum(items[c.item].samples for c in done)
            / window_s / 1e6,
            "call_ms_p50": _percentile([c.ms for c in win], 50),
            "call_ms_p95": _percentile([c.ms for c in win], 95),
            "peak_device_mib": peak / 2 ** 20,
            "setup_s": setup_s,
        }
        for m in manifest.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    checks = {"wrong_samples": {"value": wrong, "limit": 0},
              "failed_calls": {"value": failed, "limit": 0}}
    result = {
        "correct": wrong == 0 and failed == 0 and checked == len(items),
        "attempted": len(win),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if tr is not None:
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr.device_ops],
            "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    lines = [f"set-up {setup_s:.3f} s: start to inputs {t_pool - t0:.3f}, "
             f"inputs {t_warm - t_pool:.3f}, warm-up "
             f"{t0 + setup_s - t_warm:.3f}; {len(items)} streams, "
             f"{sum(len(it.data) for it in items)} bytes",
             f"checked {checked} of {len(items)} streams, "
             f"{len(win)} calls in {window_s:.3f} s"]
    lines += [f"{k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
    return result, lines
