"""device_roofline: the whole decode's least device time over the
summed time of every kernel, copy and set the trace shows. The least
time is each stream's frame bytes read once and its PCM written once at
its container's width, at the HBM bandwidth: the same work whatever
implements it, so it stays true when a kernel is fused or removed."""

from harness import peaks


def read(run):
    if run.trace is None or run.trace.device_s <= 0:
        return None
    b = 0
    for call in run.window_calls():
        c = run.items[call.item].counts
        b += c["frame_bytes"] + c["samples"] * c["channels"] * c["container_bytes"]
    return 100.0 * b / peaks.HBM_BYTES_PER_S / run.trace.device_s
