"""The control: the plain reference put in the program's place, with its
prediction computed in float32 instead of exact integers. It has to
come out as not correct: if it did not, the comparison could not tell
a decoder that rounds from one that does not.

`ControlEntry` is an entry (as entries/<entry>.py) whose answer for
each stream of the pool is the float32 reference's PCM, worked out for
the whole pool at once before the window.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


class ControlEntry:
    NORMALIZED = False
    SPANS = ()

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype
        self.out = {}

    def prepare(self, items, config, device):
        C = config["format"]["channels"]
        pcms = reference.decode([it.side for it in items], C, device,
                                self.dtype)
        self.out = {id(it.data): p for it, p in zip(items, pcms)}

    def call(self, data, device, span):
        return self.out[id(data)]

    def stats(self, res) -> dict:
        return {}

    def capture(self, res):
        return res

    def pcm(self, captured, channels: int) -> np.ndarray:
        return captured.reshape(-1, channels)
