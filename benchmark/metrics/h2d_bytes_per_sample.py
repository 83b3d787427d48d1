"""h2d_bytes_per_sample: bytes copied host to device in the traced
window (each HtoD copy of the trace, sized by the aten::copy_ that
issued it), over the PCM samples of all channels that the window's
calls decoded. Silent where a copy cannot be sized."""


def read(run):
    if run.trace is None or run.trace.h2d_bytes is None:
        return None
    samples = sum(run.items[c.item].samples for c in run.window_calls())
    return run.trace.h2d_bytes / samples if samples else None
