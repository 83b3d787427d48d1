"""Entry `decode`: the rows engine's front door, FLAC bytes to host PCM
in a DecodedFLAC with the stream MD5 verified, called with its
defaults. A call's time ends when it returns: the PCM is then usable
on the host."""

import numpy as np
import torch

import zflac_tpu_torch

# The PCM comes back normalized to its container's top bits.
NORMALIZED = True

# Program functions the traced run wraps in a span of its own:
# (module, attribute, span name).
SPANS = (
    ("zflac_tpu_torch.runtime.decode", "build_plan", "rows.plan"),
    ("zflac_tpu_torch.runtime.decode", "_run_reconstruct",
     "rows.reconstruct"),
    ("zflac_tpu_torch.runtime.decode", "_assemble", "rows.reconstruct"),
    ("zflac_tpu_torch.runtime.decode", "_finish", "rows.finish"),
)


def call(data: bytes, device, span):
    if torch.device(device).type == "cuda":
        return zflac_tpu_torch.decode(data)
    return zflac_tpu_torch.decode(data, device=device)


def stats(result) -> dict:
    return {}


def capture(result):
    """The call's output, already on the host."""
    return result.interleaved, result.channels


def pcm(captured, channels: int) -> np.ndarray:
    out, ch = captured
    if ch != channels:
        raise ValueError(f"{ch} channels, expected {channels}")
    return out.reshape(-1, channels).astype(np.int64)
