"""Reduce a torch.profiler trace of the measured window to the numbers
the per-layer readers take.

From the profiler's own events (CUPTI device activity, CPU ops and the
benchmark's `record_function` spans; all stamped in Unix-epoch ns):

- busy: the union of every kernel, copy and set on the device, clipped
  to the window; idle is the rest of the window;
- each kernel's summed time by its short name (`lpc2_kernel<8>`), and
  the summed time of every device operation;
- host-to-device bytes: each HtoD copy is tied by its linked
  correlation id to the `aten::copy_` that issued it, whose recorded
  shapes and dtypes give its bytes;
- the breakdown: the device operations that took most time, and the
  idle time by what the host was doing, named by the innermost
  benchmark span at each gap's midpoint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# Innermost first: a gap takes the first of these spans that covers it.
SPAN_ORDER = ("sync", "device.scan", "device.enqueue", "rows.plan",
              "rows.reconstruct", "rows.finish", "call")
# Element sizes by the profiler's dtype names.
_ITEMSIZE = {"bool": 1, "signed char": 1, "unsigned char": 1,
             "short int": 2, "c10::Half": 2, "c10::BFloat16": 2, "int": 4,
             "float": 4, "long int": 8, "double": 8}


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: float                      # summed device operation time
    kernel_s: dict = field(default_factory=dict)    # short name -> s
    h2d_bytes: int | None = None         # None: a copy's bytes unknown
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def short_name(name: str) -> str:
    """`void (anonymous namespace)::lpc2_kernel<8>(int const*, ...)`
    -> `lpc2_kernel<8>`; copies and sets keep their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    s = re.sub(r"^(?:[\w ()]+::)+", "", s) if "::" in s.split("<")[0] else s
    return s


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of intervals [m, 2] (sorted or not) as sorted disjoint
    intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    grp = np.cumsum(new) - 1
    out_end = np.zeros(len(starts), dtype=iv.dtype)
    np.maximum.at(out_end, grp, iv[:, 1])
    return np.stack([starts, out_end], 1)


def _h2d_bytes(events, h2d) -> int | None:
    """Bytes of the HtoD copies `h2d` (indices into `events`), or None
    if one of them cannot be tied to the aten::copy_ that issued it."""
    copies = {e.corr: e for e in events
              if e.device_type_name == "CPU" and e.name == "aten::copy_"}
    total = 0
    for i in h2d:
        c = copies.get(events[i].linked)
        if c is None or len(c.shapes) < 2 or c.dtypes[1] not in _ITEMSIZE:
            return None
        total += int(np.prod(c.shapes[1])) * _ITEMSIZE[c.dtypes[1]]
    return total


@dataclass
class _Ev:
    name: str
    device_type_name: str
    start: int
    end: int
    corr: int
    linked: int
    annotation: bool
    shapes: list
    dtypes: list


def _events(prof) -> list:
    """The profile's device events, the benchmark's spans and the
    aten::copy_ ops (the only CPU ops read)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1]
        name = e.name()
        copy = dev == "CPU" and name == "aten::copy_"
        note = e.is_user_annotation()
        if dev != "CUDA" and not copy and not note:
            continue
        out.append(_Ev(name, dev, e.start_ns(), e.start_ns() + e.duration_ns(),
                       e.correlation_id(), e.linked_correlation_id(), note,
                       list(e.shapes()) if copy else [],
                       list(e.dtypes()) if copy else []))
    return out


def reduce(prof, t0_ns: int, t1_ns: int) -> Trace:
    """Reduce the profile `prof` of the window [t0_ns, t1_ns]."""
    evs = _events(prof)
    dev_idx = [i for i, e in enumerate(evs)
               if e.device_type_name == "CUDA" and not e.annotation
               and t0_ns <= e.start < t1_ns]
    iv = np.array([[evs[i].start, evs[i].end] for i in dev_idx],
                  dtype=np.int64).reshape(-1, 2)
    clipped = np.clip(iv, t0_ns, t1_ns)
    busy = _merge(clipped[clipped[:, 1] > clipped[:, 0]])
    window = (t1_ns - t0_ns) / 1e9
    kernel_s, op_s = {}, {}
    for i in dev_idx:
        e = evs[i]
        nm = short_name(e.name)
        dt = (e.end - e.start) / 1e9
        op_s[nm] = op_s.get(nm, 0.0) + dt
        if "Memcpy" not in e.name and "Memset" not in e.name:
            kernel_s[nm] = kernel_s.get(nm, 0.0) + dt
    h2d = [i for i in dev_idx if "HtoD" in evs[i].name]
    tr = Trace(window_s=window,
               busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
               device_s=float(sum(op_s.values())), kernel_s=kernel_s,
               h2d_bytes=_h2d_bytes(evs, h2d) if h2d else None)
    tr.device_ops = sorted(([k, v] for k, v in op_s.items()),
                           key=lambda kv: -kv[1])[:10]
    tr.idle_gaps = _idle_by_span(evs, busy, t0_ns, t1_ns)
    return tr


def _busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Device-busy ns before each time t, from disjoint sorted intervals."""
    if len(busy) == 0:
        return np.zeros(len(t), dtype=np.int64)
    length = busy[:, 1] - busy[:, 0]
    cum = np.concatenate([[0], np.cumsum(length)])
    k = np.searchsorted(busy[:, 0], t, side="right") - 1
    kc = np.maximum(k, 0)
    part = np.clip(t - busy[kc, 0], 0, length[kc])
    return np.where(k >= 0, cum[kc] + part, 0)


def _idle_by_span(evs, busy: np.ndarray, t0: int, t1: int) -> list:
    """Idle seconds of the window by what the host was doing: the window
    is cut at every benchmark span's edges, each piece takes the
    innermost span open over it ("between calls" where none is), and
    each label gets the device-idle time of its pieces."""
    spans = {name: np.array([[e.start, e.end] for e in evs
                             if e.annotation and e.device_type_name == "CPU"
                             and e.name == name],
                            dtype=np.int64).reshape(-1, 2)
             for name in SPAN_ORDER}
    edges = np.unique(np.clip(np.concatenate(
        [[t0, t1]] + [sp.reshape(-1) for sp in spans.values()]), t0, t1))
    a, b = edges[:-1], edges[1:]
    if len(a) == 0:
        return []
    mid = (a + b) // 2
    label = np.full(len(a), len(SPAN_ORDER), dtype=np.int64)
    for rank, name in enumerate(SPAN_ORDER):
        sp = spans[name]
        if len(sp) == 0:
            continue
        sp = sp[np.argsort(sp[:, 0])]
        k = np.searchsorted(sp[:, 0], mid, side="right") - 1
        inside = (k >= 0) & (mid < sp[np.maximum(k, 0), 1])
        label = np.where(inside & (label == len(SPAN_ORDER)), rank, label)
    idle = (b - a) - (_busy_before(busy, b) - _busy_before(busy, a))
    names = list(SPAN_ORDER) + ["between calls"]
    sums = np.bincount(label, weights=idle / 1e9, minlength=len(names))
    out = [[names[i], float(s)] for i, s in enumerate(sums) if s > 0]
    return sorted(out, key=lambda kv: -kv[1])[:10]
