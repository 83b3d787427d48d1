"""rows.reconstruct_ms: staging, upload, device reconstruction, download and assembly (runtime/decode.py `_run_reconstruct` and `_assemble`),
mean ms a call of the traced window, from a span the benchmark wraps
around the module attribute in the traced run only."""


def read(run):
    n = sum(c.in_window for c in run.calls)
    s = run.spans.get("rows.reconstruct")
    return 1e3 * s / n if s is not None and n else None
