"""Single-buffer plan packing (counterpart of zflac_tpu/runtime/pack.py,
which imports jax at its top and so cannot be shared).

Packer lays every int32/uint32 plan array of an int32 stream into one
flat int32 numpy buffer, with the same buffer and spec as the JAX
package's Packer, so the plan reaches the device in one pinned,
non-blocking host-to-device copy (device.upload). unpack slices the
device buffer back into named views; nothing is copied on the device.
"""

from __future__ import annotations

import numpy as np
import torch


class Packer:
    """Accumulates named int32/uint32 arrays; finish() emits one flat
    int32 buffer plus the spec ((name, offset, shape, tag), ...) that
    describes how to slice it (tag "u" for arrays that were uint32)."""

    def __init__(self):
        self._entries = []
        self._arrays = []
        self._off = 0

    def add(self, name: str, arr: np.ndarray):
        a = np.ascontiguousarray(arr)
        if a.dtype == np.uint32:
            tag = "u"
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32, copy=False)
            tag = "i"
        self._entries.append((name, self._off, a.shape, tag))
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
    the spec lays them out; "u" entries are viewed as uint32."""
    out = {}
    for name, off, shape, tag in spec:
        n = int(np.prod(shape, dtype=np.int64))
        a = buf.narrow(0, off, n).view(tuple(shape))
        out[name] = a.view(torch.uint32) if tag == "u" else a
    return out
