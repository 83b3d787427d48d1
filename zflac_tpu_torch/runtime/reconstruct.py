"""Fixed-predictor integration in the pack2 time-major layout
(counterpart of zflac_tpu/runtime/reconstruct.py _fixed_integrate_t).

Fixed orders 0-4 are k-fold seeded cumulative sums (linear, hence exact
in int32 wraparound; math of zflac.zig:481-490). They stay plain tensor
ops: the JAX package leaves them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import torch


def fixed_integrate_t(rows_t, order, seeds_t):
    """rows_t: [B, n] int32 warm-up-seeded time-major rows; order: [n]
    int32 (0-4); seeds_t: [4, n] int32 finite-difference seeds. Returns
    [B, n] int32. Cumulative sums run along time in int32 wraparound,
    as the JAX function's do."""
    B, n = rows_t.shape
    row = torch.arange(B, device=rows_t.device)[:, None]
    work = rows_t
    for j in range(3, -1, -1):
        active = (order > j)[None, :]
        m = torch.where(row < j, 0,
                        torch.where(row == j, seeds_t[j:j + 1, :], work))
        c = torch.cumsum(m, dim=0, dtype=torch.int32)
        work = torch.where(active & (row >= j), c, work)
    return work
