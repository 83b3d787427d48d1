"""Fixed-predictor integration and stereo decorrelation in the pack2
time-major layout (counterparts of zflac_tpu/runtime/reconstruct.py
_fixed_integrate_t, of the decorrelation in zflac_tpu/runtime/device.py
and of their 64-bit pair twins in zflac_tpu/runtime/wide.py).

Both run in the dtype of their inputs: int32 on the int32 path, int64
on wide chunks (33-bit side channels), where the JAX package carries
(hi, lo) int32 pairs instead. They stay plain tensor ops: the JAX
package leaves them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import torch

from zflac_tpu import format as fmt


def fixed_integrate_t(rows_t, order, seeds_t):
    """rows_t: [B, n] warm-up-seeded time-major rows, int32 or int64;
    order: [n] int32 (0-4); seeds_t: [4, n] finite-difference seeds of
    the rows' dtype. Returns [B, n] of that dtype. Fixed orders are
    k-fold seeded cumulative sums (zflac.zig:481-490), linear and
    therefore exact in wraparound; the sums run along time in the rows'
    dtype, as the JAX functions' do in int32 and in int32 pairs."""
    B, n = rows_t.shape
    row = torch.arange(B, device=rows_t.device)[:, None]
    work = rows_t
    for j in range(3, -1, -1):
        active = (order > j)[None, :]
        m = torch.where(row < j, 0,
                        torch.where(row == j, seeds_t[j:j + 1, :], work))
        c = torch.cumsum(m, dim=0, dtype=rows_t.dtype)
        work = torch.where(active & (row >= j), c, work)
    return work


def decorrelate2(c0, c1, mode):
    """Stereo decorrelation (zflac.zig:553-578) of channel planes c0,
    c1 by channel code `mode` (broadcast against them): left-side,
    side-right and mid-side; independent frames pass through. In int64
    the mid-side sum keeps its bit 32, which a 33-bit side channel
    needs."""
    mid = (c0 << 1) | (c1 & 1)
    new0 = torch.where(
        mode == fmt.CH_SIDE_RIGHT, c0 + c1,
        torch.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
    new1 = torch.where(
        mode == fmt.CH_LEFT_SIDE, c0 - c1,
        torch.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
    return new0, new1
