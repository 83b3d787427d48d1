"""scan_ms: the host scan of a decode_to_device call (index/
native_indexer.py pack2_range through runtime/device.py stream_chunks),
mean ms a call, from the program's own span `stats["scan_ms"]`."""

import numpy as np


def read(run):
    v = [c.stats["scan_ms"] for c in run.window_calls() if "scan_ms" in c.stats]
    return float(np.mean(v)) if v else None
