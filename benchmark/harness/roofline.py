"""A kernel's share of its roofline, from the stream's content.

Each kernel's file, roofline/<kernel>.py, names the kernel as the trace
shows it (`KERNEL`, a regular expression on the short name) and counts
its least work for one stream from the counts the encoder kept
(`work(counts) -> (bytes, operations)`): each input byte read once and
each output byte written once, at the widths the FLAC format implies,
never from the program's padded buffers. The least time of the calls
in the window is the larger of their bytes over the HBM bandwidth and
their operations over the integer peak (peaks.py); the share is that
time over the kernel's summed time in the trace.
"""

from __future__ import annotations

import re

from . import manifest, peaks


def least_s(bytes_: float, ops: float) -> float:
    return max(bytes_ / peaks.HBM_BYTES_PER_S, ops / peaks.INT_OPS_PER_S)


def kernel_share(run, kernel: str):
    """Percent of its roofline that `kernel` reached over the traced
    window, or None where the trace shows no such kernel."""
    if run.trace is None:
        return None
    mod = manifest.module("roofline", kernel)
    pat = re.compile(mod.KERNEL)
    t = sum(s for name, s in run.trace.kernel_s.items() if pat.fullmatch(name))
    if t <= 0:
        return None
    b = o = 0.0
    for call in run.window_calls():
        wb, wo = mod.work(run.items[call.item].counts)
        b += wb
        o += wo
    return 100.0 * least_s(b, o) / t
