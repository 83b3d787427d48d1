"""Decoded-stream result type, mirroring the reference's public surface
(`DecodedFLAC` with channels / sample_rate / bits_per_sample / samples,
the reference's src/zflac.zig:18-28), TPU-framework style: samples are a
numpy array (interleaved container-width ints), convertible to a
[n, channels] view.

The port's copy of zflac_tpu/result.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .format import container_bits

_CONTAINER_DTYPE = {8: np.int8, 16: np.int16, 32: np.int32}


def container_dtype(bps: int):
    return _CONTAINER_DTYPE[container_bits(bps)]


@dataclass
class DecodedFLAC:
    """Decode result.

    `interleaved` matches the reference's backing buffer layout
    (channel-major within each sample index, zflac.zig:331-334,443):
    sample i of channel c lives at interleaved[i * channels + c].
    """

    channels: int
    sample_rate: int
    bits_per_sample: int
    interleaved: np.ndarray
    #: Optional decode metadata (frame count, subframe type histogram, ...)
    stats: dict = field(default_factory=dict)

    @property
    def num_samples(self) -> int:
        """Per-channel sample count."""
        return len(self.interleaved) // self.channels

    @property
    def samples(self) -> np.ndarray:
        """[num_samples, channels] view."""
        return self.interleaved.reshape(-1, self.channels)

    def channel(self, c: int) -> np.ndarray:
        return self.interleaved[c::self.channels]
