"""lpc2w and lpc2w33: the LPC recurrence of one order class with a
64-bit accumulator (counterparts of zflac_tpu/ops/lpc2w.py
lpc2w_reconstruct_inline and lpc2w33_reconstruct_inline; kernels in
csrc/lpc2w.cu).

The transposed direct form of ops/lpc2.py, with the reference's i64
InterType (zflac.zig:314-319): the prediction is the exact 64-bit sum
shifted right. lpc2w serves streams in the 32-bit container (17-32
bps): int32 samples, pred = the low word of acc >> shift. lpc2w33
serves wide chunks, whose side channels carry 33-bit samples: int64
rows in and out, pred = acc >> shift in all 64 bits.

The JAX package carries the accumulator as (hi, lo) int32 pairs
because the TPU has no int64; here it is int64 (the lpc2w kernel runs
it in float64 where every coefficient of a warp fits 16 bits, which is
exact there, csrc/lpc2w.cu; lpc2w33's kernel runs the int64 step it
shares with lpc64, csrc/lpc_steps.cuh). The two agree bit for bit
wherever each partial product of the pair split is exact in int32,
which holds for every coefficient the host scan admits (at most 16
bits). Shift amounts follow the JAX step math for every uint32 value
(the scan writes 0..31): for amounts >= 32 lpc2w's pred is 0, and
lpc2w33's is the sign fill of the high word with a zero low word.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .lpc2 import launch_recurrence


def _low32(x):
    """The low 32 bits of int64 `x` as a signed value (still int64)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def lpc2w_reconstruct_ref(rows_t, cfwd_t, shift, order):
    """Plain PyTorch version of the lpc2w kernel: a Python loop over
    time on int64 [n]-wide tensors. rows_t: [B, n] int32; cfwd_t:
    [hist, n] int32 (row r = c_{r+1}, zero for r >= order); shift,
    order: [n] int32. Returns [B, n] int32."""
    B, n = rows_t.shape
    hist = cfwd_t.shape[0]
    dev = rows_t.device
    c = cfwd_t.long()
    big = (shift.long() & 0xFFFFFFFF) >= 32
    sh = torch.where(big, 0, shift.long())
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    P = torch.zeros((hist, n), dtype=torch.int64, device=dev)
    zrow = P[:1].clone()
    for t in range(B):
        res = rows_t[t].long()
        pred = torch.where(big, 0, _low32(P[0] >> sh))
        o = torch.where(order <= t, _low32(res + pred), res)
        out[t] = o
        P = torch.cat([P[1:], zrow]) + o * c
    return out


def lpc2w_reconstruct(rows_t, cfwd_t, shift, order):
    """lpc2w on the device of its inputs: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Arguments as
    lpc2_reconstruct (column slices allowed, hist 8/16/32, B a
    multiple of 8 for the kernel)."""
    if _kernels.route(rows_t, cfwd_t, shift, order) == "cpu":
        return lpc2w_reconstruct_ref(rows_t, cfwd_t, shift, order)
    return launch_recurrence("lpc2w", torch.int32, rows_t, cfwd_t, shift,
                             order)


def lpc2w33_reconstruct_ref(rows_t, cfwd_t, shift, order):
    """Plain PyTorch version of the lpc2w33 kernel. rows_t: [B, n]
    int64 (33-bit samples); cfwd_t, shift, order as lpc2w. Returns
    [B, n] int64."""
    B, n = rows_t.shape
    hist = cfwd_t.shape[0]
    dev = rows_t.device
    c = cfwd_t.long()
    big = (shift.long() & 0xFFFFFFFF) >= 32
    sh = torch.where(big, 63, shift.long())
    keep = torch.where(big, -(1 << 32), -1)
    out = torch.empty((B, n), dtype=torch.int64, device=dev)
    P = torch.zeros((hist, n), dtype=torch.int64, device=dev)
    zrow = P[:1].clone()
    for t in range(B):
        res = rows_t[t]
        o = torch.where(order <= t, res + ((P[0] >> sh) & keep), res)
        out[t] = o
        P = torch.cat([P[1:], zrow]) + o * c
    return out


def lpc2w33_reconstruct(rows_t, cfwd_t, shift, order):
    """lpc2w33 on the device of its inputs: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. rows_t is int64;
    otherwise as lpc2w_reconstruct."""
    if _kernels.route(rows_t, cfwd_t, shift, order) == "cpu":
        return lpc2w33_reconstruct_ref(rows_t, cfwd_t, shift, order)
    return launch_recurrence("lpc2w33", torch.int64, rows_t, cfwd_t, shift,
                             order)
