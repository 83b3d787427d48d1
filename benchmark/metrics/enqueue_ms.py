"""enqueue_ms: uploading a decode_to_device call's scan buffers and
queueing their kernels (runtime/device.py reconstruct_chunks), mean ms
a call, from the program's own span `stats["enqueue_ms"]`."""

import numpy as np


def read(run):
    v = [c.stats["enqueue_ms"] for c in run.window_calls()
         if "enqueue_ms" in c.stats]
    return float(np.mean(v)) if v else None
