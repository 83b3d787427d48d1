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


def row_index(idx, n: int):
    """idx as the int64 indices XLA's gather rule reads from n rows:
    negative ones first count from the end, as jnp indexing reads
    them, then all are clamped into [0, n - 1]. One index serves every
    gather along rows of the same count."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.clamp(idx, 0, n - 1)


def gather_rows(a, idx):
    """a[idx] along dim 0 with XLA's gather rule (row_index)."""
    return a[row_index(idx, a.shape[0])]


def scatter_rows(canvas, idx, updates):
    """canvas.at[idx].set(updates) along dim 0 where entries of idx >=
    canvas.shape[0] are sentinels whose updates are discarded. Returns
    a new tensor."""
    n = canvas.shape[0]
    padded = torch.cat([canvas, canvas.new_zeros((1, *canvas.shape[1:]))])
    return put_rows_(padded, idx, updates)[:n]


def put_rows_(padded, idx, updates):
    """scatter_rows in place on a canvas that already holds the dead
    row: padded has n + 1 rows, and entries of idx >= n write row n.
    Returns padded."""
    n = padded.shape[0] - 1
    padded[torch.clamp(idx.long(), max=n)] = updates.to(padded.dtype)
    return padded


def scatter_flat(flat, idx, vals):
    """1-D variant: flat.at[idx].set(vals) with sentinels (>= len)
    discarded."""
    return scatter_rows(flat, idx, vals)
