"""Host-clock timers of the decode pipeline (the port's copy of
zflac_tpu/utils/timer.py, extended with the port's per-call recorder).

Two pieces:

- `StageTimers`: named stages a caller times itself, summed in seconds.
- The per-call recorder: an entry point (`decode`, `decode_to_device`,
  `decode_pack2_distributed`) opens one for its call with
  `recording()`, and `span(name)` and `count(name, n)` anywhere below it
  in the call (the scan, the upload, the plan build) write into it with
  no argument passed down. The entry returns what was recorded in its
  result's `stats`. A span adds its host-clock time to `<name>_ms`, the
  dots of its name made underscores (`span("scan.ranges")` ->
  `scan_ranges_ms`); a counter adds `n` to `name`. With no call open
  (a tool calling a layer directly) both record nothing.

A span is also a `torch.profiler.record_function` range named
`zflac.<name>`, but only while a profiler is active and only on the
thread that opened the call: the profiler then stamps it on the clock of
its CUDA device events, so a trace's idle gaps can be laid against the
program's phases. With no profiler active a span costs two
`perf_counter` reads and a dict update, and no `record_function` is
entered. A recorder is written by one thread only, so it takes no lock:
a worker thread of the call runs in a copy of the call's context
(`contextvars.copy_context()`), opens a recorder of its own there, which
keeps the call's thread and so stays off the timeline, and hands its
`stats` back for the calling thread to `merge()`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

import torch

_call: contextvars.ContextVar = contextvars.ContextVar(
    "zflac_tpu_torch_call", default=None)
_profiling = torch.autograd._profiler_enabled
# Span name -> its stats key (a cache: the names are a fixed few).
_keys: dict[str, str] = {}


class StageTimers:
    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    def as_dict(self) -> dict[str, float]:
        return dict(self.times)

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}={v * 1e3:.1f}ms"
                          for k, v in self.times.items())
        return f"StageTimers({parts})"


class CallStats:
    """One entry call's spans and counters: `stats`, key -> number, and
    the thread that opened the outermost call (the only one whose spans
    reach the profiler's timeline)."""

    __slots__ = ("stats", "thread")

    def __init__(self, thread: int):
        self.stats: dict[str, float] = {}
        self.thread = thread

    def add(self, key: str, n) -> None:
        self.stats[key] = self.stats.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """Open a recorder for the enclosed call and yield its CallStats. A
    call opened inside another records into its own, and keeps the
    outer call's thread."""
    outer = _call.get()
    rec = CallStats(threading.get_ident() if outer is None else outer.thread)
    token = _call.set(rec)
    try:
        yield rec
    finally:
        _call.reset(token)


def count(name: str, n) -> None:
    """Add `n` (an int or a float) to the open call's counter `name`."""
    rec = _call.get()
    if rec is not None:
        rec.add(name, n)


def merge(stats: dict) -> None:
    """Add each of a worker's recorded `stats` to the open call's."""
    rec = _call.get()
    if rec is not None:
        for key, n in stats.items():
            rec.add(key, n)


class span:
    """`with span("scan.anchors"):` adds the block's host-clock ms to the
    open call's `scan_anchors_ms` (also when the block raises), and puts
    it on an active profiler's timeline as `zflac.scan.anchors`."""

    __slots__ = ("name", "_rec", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self._rec = _call.get()
        if rec is not None:
            self._range = None
            if _profiling() and rec.thread == threading.get_ident():
                self._range = torch.profiler.record_function(
                    "zflac." + self.name)
                self._range.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            if self._range is not None:
                self._range.__exit__(*exc)
            key = _keys.get(self.name)
            if key is None:
                key = _keys[self.name] = self.name.replace(".", "_") + "_ms"
            stats = rec.stats
            stats[key] = stats.get(key, 0) + ms
        return False
