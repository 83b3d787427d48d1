"""lpc2: the int32 LPC recurrence of one order class in time-major
form (counterpart of zflac_tpu/ops/lpc2.py lpc2_reconstruct_inline;
kernel in csrc/lpc2.cu).

Transposed direct form: a pipeline P[hist] holds, in P[r], the partial
prediction for time t+1+r from every sample produced so far. Per step
pred = P[0] >> shift, out = res + pred where t >= order (warm-ups pass
through), then P = shift_up(P) + out * c with c[r] = c_{r+1}. int32
wraparound sums are associative, so this equals the reference's
index-order sum bit for bit (InterType i32 for <= 16-bit streams).
"""

from __future__ import annotations

import torch

from .. import _kernels

HISTS = (8, 16, 32)


def lpc2_reconstruct_ref(rows_t, cfwd_t, shift, order):
    """Plain PyTorch version of the lpc2 kernel: a Python loop over
    time on [n]-wide tensors. rows_t: [B, n] int32; cfwd_t: [hist, n]
    int32 (row r = c_{r+1}, zero for r >= order); shift, order: [n]
    int32. Returns [B, n] int32."""
    B, n = rows_t.shape
    hist = cfwd_t.shape[0]
    out = torch.empty((B, n), dtype=torch.int32, device=rows_t.device)
    P = torch.zeros((hist, n), dtype=torch.int32, device=rows_t.device)
    zrow = P[:1].clone()
    for t in range(B):
        res = rows_t[t]
        o = torch.where(order <= t, res + (P[0] >> shift), res)
        out[t] = o
        P = torch.cat([P[1:], zrow]) + o * cfwd_t
    return out


def lpc2_reconstruct(rows_t, cfwd_t, shift, order):
    """lpc2 on the device of its inputs: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. rows_t and cfwd_t may
    be column slices of wider arrays (contiguous rows, any row stride);
    hist = cfwd_t.shape[0] is 8, 16 or 32 and B a multiple of 8 for
    the kernel."""
    if _kernels.route(rows_t, cfwd_t, shift, order) == "cpu":
        return lpc2_reconstruct_ref(rows_t, cfwd_t, shift, order)
    return launch_recurrence("lpc2", torch.int32, rows_t, cfwd_t, shift,
                             order)


def launch_recurrence(name, dtype, rows_t, cfwd_t, shift, order):
    """Check the arguments of the LPC recurrence kernel `name` (lpc2,
    lpc2w, lpc2w33: rows and output of `dtype`, the rest int32) and
    launch it on CUDA tensors. Returns the output [B, n]."""
    B, n = rows_t.shape
    hist = cfwd_t.shape[0]
    if hist not in HISTS:
        raise ValueError(f"{name}: hist {hist} (kernel takes {HISTS})")
    if B % 8:
        raise ValueError(f"{name}: B {B} is not a multiple of 8")
    _kernels.check(rows_t, "rows_t", dtype, inner_contiguous=True)
    _kernels.check(cfwd_t, "cfwd_t", torch.int32, shape=(hist, n),
                   inner_contiguous=True)
    _kernels.check(shift, "shift", torch.int32, shape=(n,))
    _kernels.check(order, "order", torch.int32, shape=(n,))
    out = torch.empty((B, n), dtype=dtype, device=rows_t.device)
    if n == 0 or B == 0:
        return out
    _kernels.launch(name, rows_t.device, rows_t.data_ptr(),
                    rows_t.stride(0), cfwd_t.data_ptr(), cfwd_t.stride(0),
                    shift.data_ptr(), order.data_ptr(), out.data_ptr(),
                    B, n, hist)
    return out
