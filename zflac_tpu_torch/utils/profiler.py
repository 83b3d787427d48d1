"""Optional torch.profiler tracing for the decode pipeline (counterpart
of zflac_tpu/utils/profiler.py, which traces with jax.profiler).

Set ZFLAC_TPU_PROFILE=/some/dir to capture a torch.profiler trace of
every whole `decode()` (the torch engine: plan through finish) and
`decode_to_device()` (scan through enqueue) call: one Chrome trace file
per call in that directory (open it in chrome://tracing or Perfetto),
with the call under the label passed to maybe_trace, the program's
`zflac.*` spans inside it (utils/timer.py) and, when the decode runs on
a card, the CUDA kernels it launched. No-op (one environment check at
import) when unset."""

from __future__ import annotations

import contextlib
import itertools
import os

_PROFILE_DIR = os.environ.get("ZFLAC_TPU_PROFILE", "")
_calls = itertools.count()


@contextlib.contextmanager
def maybe_trace(label: str, device="cpu"):
    """Trace the enclosed region under `label` when ZFLAC_TPU_PROFILE
    names a directory: CPU activity, and CUDA activity when `device` is
    a CUDA device."""
    if not _PROFILE_DIR:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(_PROFILE_DIR, exist_ok=True)
    path = os.path.join(_PROFILE_DIR,
                        f"{label}.{os.getpid()}.{next(_calls)}.json")
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
    prof.export_chrome_trace(path)
