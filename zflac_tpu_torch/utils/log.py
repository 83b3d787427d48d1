"""Scoped debug logging, mirroring the reference's four std.log scopes
(.zflac / .zflac_frame / .zflac_subframe / .zflac_residual,
the reference's src/zflac.zig:5-8). Enable with e.g.
ZFLAC_TPU_LOG=frame,residual or ZFLAC_TPU_LOG=all.

The port's copy of zflac_tpu/utils/log.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

import logging
import os

SCOPES = ("stream", "frame", "subframe", "residual", "kernel", "shard")


def scoped_loggers() -> dict[str, logging.Logger]:
    return {s: logging.getLogger(f"zflac_tpu_torch.{s}") for s in SCOPES}


def get_logger(scope: str) -> logging.Logger:
    assert scope in SCOPES, scope
    return logging.getLogger(f"zflac_tpu_torch.{scope}")


def _configure_from_env() -> None:
    spec = os.environ.get("ZFLAC_TPU_LOG", "")
    if not spec:
        return
    wanted = SCOPES if spec == "all" else tuple(
        s.strip() for s in spec.split(","))
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(name)s: %(message)s"))
    for s in wanted:
        if s in SCOPES:
            lg = get_logger(s)
            lg.setLevel(logging.DEBUG)
            lg.addHandler(handler)


_configure_from_env()
