"""Entry `decode_to_device`: the pack2 path, FLAC bytes to PCM in
device memory, called with its defaults. A call's time ends once it
has returned and `torch.cuda.synchronize()` has finished: the PCM is
then usable on the card."""

import numpy as np
import torch

import zflac_tpu_torch

# The PCM comes back normalized to its container's top bits.
NORMALIZED = False

# Program functions the traced run wraps in a span of its own:
# (module, attribute, span name).
SPANS = (
    ("zflac_tpu_torch.runtime.device", "stream_chunks", "device.scan"),
    ("zflac_tpu_torch.runtime.device", "reconstruct_chunks",
     "device.enqueue"),
)


def call(data: bytes, device, span):
    """Decode `data`; None where the program declines the stream."""
    if torch.device(device).type == "cuda":
        dd = zflac_tpu_torch.decode_to_device(data)
        with span("sync"):
            torch.cuda.synchronize()
    else:
        dd = zflac_tpu_torch.decode_to_device(data, device=device)
    return dd


def stats(dd) -> dict:
    """The program's own host-clock spans of the call."""
    return {k: dd.stats[k] for k in ("scan_ms", "enqueue_ms")
            if k in dd.stats}


def capture(dd):
    """A host copy of the call's output: per chunk its PCM [F, Bp, C]
    and the block size of each of its F frames."""
    return [(pcm[:F].cpu().numpy(), np.asarray(bs[:F]))
            for pcm, F, bs in zip(dd.chunks, dd.num_frames, dd.block_sizes)]


def pcm(captured, channels: int) -> np.ndarray:
    """Interleaved PCM [n, channels] of a captured output: each frame's
    first block-size samples, frames in order."""
    parts = []
    for p, bs in captured:
        if p.shape[-1] != channels:
            raise ValueError(f"{p.shape[-1]} channels, expected {channels}")
        keep = np.arange(p.shape[1])[None, :] < bs[:, None]
        parts.append(p[keep])
    if not parts:
        return np.zeros((0, channels), dtype=np.int64)
    return np.concatenate(parts).astype(np.int64)
