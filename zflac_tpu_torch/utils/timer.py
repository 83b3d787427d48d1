"""Per-stage wall-clock timers for the decode pipeline (the port's copy
of zflac_tpu/utils/timer.py; pairs with utils/profiler.py's
torch.profiler traces for the device side)."""

from __future__ import annotations

import contextlib
import time


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
