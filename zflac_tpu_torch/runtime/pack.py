"""Single-buffer plan packing (counterpart of zflac_tpu/runtime/pack.py,
which imports jax at its top and so cannot be shared).

Packer lays every plan array into one flat int32 numpy buffer, so the
plan reaches the device in one pinned, non-blocking host-to-device copy
(device.upload). int32 and uint32 arrays take the JAX package's Packer
layout: for them the buffer and spec are that Packer's, byte for byte.
An int64 array (the rows of a 17-32-bit stream) goes in as int32 word
pairs at an even word offset, so that its device view is aligned. unpack
slices the device buffer back into named views; nothing is copied on
the device.
"""

from __future__ import annotations

import numpy as np
import torch


class Packer:
    """Accumulates named int32/uint32/int64 arrays; finish() emits one
    flat int32 buffer plus the spec ((name, offset, shape, tag), ...)
    that describes how to slice it (tag "u" for arrays that were uint32,
    "l" for int64 ones, whose offset is even and counts int32 words)."""

    def __init__(self):
        self._entries = []
        self._arrays = []
        self._off = 0

    def add(self, name: str, arr: np.ndarray):
        a = np.ascontiguousarray(arr)
        shape = a.shape
        if a.dtype == np.uint32:
            tag = "u"
            a = a.view(np.int32)
        elif a.dtype == np.int64:
            tag = "l"
            if self._off % 2:
                self._arrays.append(np.zeros(1, np.int32))
                self._off += 1
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32, copy=False)
            tag = "i"
        self._entries.append((name, self._off, shape, tag))
        self._arrays.append(a.reshape(-1))
        self._off += a.size

    def finish(self):
        buf = np.empty(max(self._off, 1), np.int32)
        at = 0
        for a in self._arrays:
            buf[at:at + a.size] = a
            at += a.size
        return buf, tuple(self._entries)


def unpack(buf, spec) -> dict:
    """Named views of the packed int32 tensor `buf` (on any device), as
    the spec lays them out; "u" entries are viewed as uint32, "l"
    entries as int64."""
    out = {}
    for name, off, shape, tag in spec:
        n = int(np.prod(shape, dtype=np.int64))
        if tag == "l":
            out[name] = buf.narrow(0, off, 2 * n).view(torch.int64).view(
                tuple(shape))
            continue
        a = buf.narrow(0, off, n).view(tuple(shape))
        out[name] = a.view(torch.uint32) if tag == "u" else a
    return out
