"""lpc and lpc64: the rows engine's LPC recurrence over a 32-sample
history, time-major (counterpart of zflac_tpu/ops/lpc.py
lpc_reconstruct_inline at int32, and of the XLA scan _lpc_scan of
zflac_tpu/runtime/reconstruct.py at int64; kernels in csrc/lpc.cu).

  out[t] = rows[t] + ((sum_j X[t+j] * coeffs_t[j]) >> shift)  (t >= order)
  out[t] = rows[t]                                            (t < order)

with X the output preceded by 32 zeros, sums wrapping in the rows'
dtype and an arithmetic right shift whose amount, read as unsigned, is
taken as the width minus one when it reaches the width (XLA's sign
fill for such amounts). int32 rows go to the lpc kernel, int64 rows to
lpc64. Both kernels run each warp of 32 subframes with as many taps
(8, 16 or 32) as its highest nonzero coefficient row needs; the rows
dropped are zero, so the result is the same for any coefficients.
"""

from __future__ import annotations

import torch

from .. import _kernels

HIST = 32
KERNEL = {torch.int32: "lpc", torch.int64: "lpc64"}


def clamp_shift(shift, dtype):
    """Shift amounts as the kernels use them: those outside [0, width)
    (a negative int32 reads as a large unsigned amount) become
    width - 1, which gives XLA's sign fill."""
    bits = torch.iinfo(dtype).bits
    return torch.where((shift < 0) | (shift >= bits), bits - 1,
                       shift).to(dtype)


def lpc_reconstruct_ref(rows_t, coeffs_t, shift, order):
    """Plain PyTorch version of the lpc and lpc64 kernels: a Python loop
    over time on [S]-wide tensors, in the transposed form of
    ops/lpc2.py (P[r] holds the partial prediction for time t+1+r;
    sums with wraparound are associative, so this equals the direct
    form bit for bit). rows_t: [B, S] int32 or int64; coeffs_t: [32, S]
    int32 (row j multiplies s[t-32+j]); shift, order: [S] int32.
    Returns [B, S] of the rows' dtype."""
    B, S = rows_t.shape
    dtype = rows_t.dtype
    dev = rows_t.device
    c = coeffs_t.flip(0).to(dtype)           # row r: the sample r+1 back
    sh = clamp_shift(shift, dtype)
    out = torch.empty((B, S), dtype=dtype, device=dev)
    P = torch.zeros((HIST, S), dtype=dtype, device=dev)
    zrow = P[:1].clone()
    for t in range(B):
        res = rows_t[t]
        o = torch.where(order <= t, res + (P[0] >> sh), res)
        out[t] = o
        P = torch.cat([P[1:], zrow]) + o * c
    return out


def lpc_reconstruct(rows_t, coeffs_t, shift, order):
    """lpc (int32 rows) or lpc64 (int64 rows) on the device of its
    inputs: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Shapes as lpc_reconstruct_ref; rows_t and coeffs_t may be
    views with contiguous rows and any row stride; B a multiple of 8
    for the kernel, any S."""
    if _kernels.route(rows_t, coeffs_t, shift, order) == "cpu":
        return lpc_reconstruct_ref(rows_t, coeffs_t, shift, order)
    name = KERNEL.get(rows_t.dtype)
    if name is None:
        raise TypeError(f"lpc: rows of dtype {rows_t.dtype} (kernels take "
                        "int32 and int64)")
    B, S = rows_t.shape
    if B % 8:
        raise ValueError(f"{name}: B {B} is not a multiple of 8")
    _kernels.check(rows_t, "rows_t", rows_t.dtype, inner_contiguous=True)
    _kernels.check(coeffs_t, "coeffs_t", torch.int32, shape=(HIST, S),
                   inner_contiguous=True)
    _kernels.check(shift, "shift", torch.int32, shape=(S,))
    _kernels.check(order, "order", torch.int32, shape=(S,))
    out = torch.empty((B, S), dtype=rows_t.dtype, device=rows_t.device)
    if S == 0 or B == 0:
        return out
    _kernels.launch(name, rows_t.device, rows_t.data_ptr(), rows_t.stride(0),
                    coeffs_t.data_ptr(), coeffs_t.stride(0), shift.data_ptr(),
                    order.data_ptr(), out.data_ptr(), B, S)
    return out
