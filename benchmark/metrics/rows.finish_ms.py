"""rows.finish_ms: the MD5 check and normalisation (runtime/decode.py `_finish`),
mean ms a call of the traced window, from a span the benchmark wraps
around the module attribute in the traced run only."""


def read(run):
    n = sum(c.in_window for c in run.calls)
    s = run.spans.get("rows.finish")
    return 1e3 * s / n if s is not None and n else None
