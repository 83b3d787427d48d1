"""Sentinel-safe scatters and gathers (counterpart of
zflac_tpu/runtime/scatter.py).

Class gather lists are padded to static sizes with an out-of-range
sentinel (one past the last valid row). The JAX package relies on
XLA's index rules there: a gather clamps an out-of-range index onto
the last row, and a scatter must drop the sentinel's update. Torch
indexing does neither: it raises on the CPU and trips a device-side
assert on CUDA, which ends the process's CUDA context. So no index
reaches torch out of range: gathers clamp as XLA does, and scatters
clamp sentinels onto one dead slot past the end that is dropped
afterwards.
"""

from __future__ import annotations

import torch


def gather_rows(a, idx):
    """a[idx] along dim 0 with XLA's gather rule: indices are clamped
    into [0, a.shape[0] - 1] (negative ones first count from the end,
    as jnp indexing reads them)."""
    n = a.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return a[torch.clamp(idx, 0, n - 1)]


def scatter_rows(canvas, idx, updates):
    """canvas.at[idx].set(updates) along dim 0 where entries of idx >=
    canvas.shape[0] are sentinels whose updates are discarded. Returns
    a new tensor."""
    n = canvas.shape[0]
    padded = torch.cat([canvas, canvas.new_zeros((1, *canvas.shape[1:]))])
    padded[torch.clamp(idx.long(), max=n)] = updates.to(canvas.dtype)
    return padded[:n]


def scatter_flat(flat, idx, vals):
    """1-D variant: flat.at[idx].set(vals) with sentinels (>= len)
    discarded."""
    return scatter_rows(flat, idx, vals)
