"""Batched signal reconstruction (counterpart of
zflac_tpu/runtime/reconstruct.py).

Fixed-predictor integration and stereo decorrelation in the pack2
time-major layout (counterparts of _fixed_integrate_t, of the
decorrelation in zflac_tpu/runtime/device.py and of their 64-bit pair
twins in zflac_tpu/runtime/wide.py), and the rows engine's core, which
turns the dense plan arrays into PCM: const broadcast, verbatim, fixed
cumsums and the LPC classes (the lpc kernel at int32, lpc64 at int64
and for the widened `lpc_wide` class), then the wasted shift, the
decorrelation and the container cast.

Everything runs in the dtype of its inputs: int32 on the int32 path,
int64 on wide chunks and 17-32-bit streams, where the JAX package
carries (hi, lo) int32 pairs or runs under x64. Apart from the LPC
kernel these stay plain tensor ops: the JAX package leaves them to XLA,
not to a Pallas kernel.
"""

from __future__ import annotations

import torch

from .. import format as fmt
from ..ops.lpc import clamp_shift, lpc_reconstruct
from .pack import unpack
from .scatter import gather_rows, scatter_rows
from .wide import wrap_to


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


# ---------------------------------------------------------------------
# The rows engine (counterpart of zflac_tpu/runtime/reconstruct.py
# _reconstruct_core, reconstruct and reconstruct_packed): dense plan
# arrays, subframe-major [S, B], in; container-width PCM [F, B, C] out.
# ---------------------------------------------------------------------


def fixed_integrate(rows, order, seeds):
    """Subframe-major twin of fixed_integrate_t (counterpart of
    _fixed_integrate): rows [n, B] warm-up-seeded, order [n], seeds
    [n, 4]. Returns [n, B] of the rows' dtype."""
    return fixed_integrate_t(rows.t(), order, seeds.t()).t()


def lpc_scan(rows, coeffs_rev, shift, order):
    """Plain direct-form LPC recurrence over a 32-sample window
    (counterpart of _lpc_scan), in the rows' dtype: rows [n, B],
    coeffs_rev [n, 32] (slot 31-j multiplies s[t-1-j]), shift, order
    [n]. Returns [n, B]. The tests' reference for the lpc kernels."""
    n, B = rows.shape
    dtype = rows.dtype
    coeffs = coeffs_rev.to(dtype)
    sh = clamp_shift(shift, dtype)
    window = torch.zeros((n, 32), dtype=dtype, device=rows.device)
    out = torch.empty_like(rows)
    for t in range(B):
        pred = torch.sum(window * coeffs, dim=1, dtype=dtype) >> sh
        o = torch.where(order <= t, rows[:, t] + pred, rows[:, t])
        out[:, t] = o
        window = torch.cat([window[:, 1:], o[:, None]], dim=1)
    return out


def lpc_class_inputs(rows, coeffs_rev, shift, order, idx, *,
                     widen: bool = False):
    """The lpc kernel's time-major arguments for the LPC class with
    padded gather list idx: (rows [B, n], coeffs [32, n], shift [n],
    order [n]), rows widened to int64 when `widen` (the lpc_wide
    class)."""
    rows_g = gather_rows(rows, idx)
    if widen:
        rows_g = rows_g.long()
    return (rows_g.t().contiguous(), gather_rows(coeffs_rev, idx).t()
            .contiguous(), gather_rows(shift, idx), gather_rows(order, idx))


def reconstruct_core(rows, kind, order, wasted, shift, coeffs_rev,
                     fixed_seeds, class_idx, channel_code, *,
                     num_channels: int, container_bits: int,
                     do_decorrelate: bool):
    """Plan tensors -> container-width PCM [F, B, C] (pre-normalization)
    on their device. rows [S, B] int32 or int64; class_idx: name ->
    padded int32 gather list whose entries >= S are sentinels. kind is
    not read (the class lists carry it), as in the JAX core."""
    S, B = rows.shape
    dtype = rows.dtype
    signal = torch.zeros((S, B), dtype=dtype, device=rows.device)

    idx = class_idx.get("const")
    if idx is not None:
        vals = gather_rows(rows, idx)[:, 0:1].expand(idx.shape[0], B)
        signal = scatter_rows(signal, idx, vals)

    idx = class_idx.get("verbatim")
    if idx is not None:
        signal = scatter_rows(signal, idx, gather_rows(rows, idx))

    idx = class_idx.get("fixed")
    if idx is not None:
        out = fixed_integrate(gather_rows(rows, idx), gather_rows(order, idx),
                              gather_rows(fixed_seeds, idx))
        signal = scatter_rows(signal, idx, out)

    idx = class_idx.get("lpc")
    if idx is not None:
        out = lpc_reconstruct(*lpc_class_inputs(rows, coeffs_rev, shift,
                                                order, idx)).t()
        signal = scatter_rows(signal, idx, out)

    idx = class_idx.get("lpc_wide")
    if idx is not None:
        # An int32 stream's class whose accumulator may pass 32 bits:
        # lpc64 (the reference's InterType widening, zflac.zig:314-319),
        # then back to the stream dtype with wraparound.
        out = lpc_reconstruct(*lpc_class_inputs(
            rows, coeffs_rev, shift, order, idx, widen=True)).t()
        signal = scatter_rows(signal, idx, wrap_to(out, dtype))

    # Wasted-bits shift (zflac.zig:447,459,495-496,538-539).
    signal = signal << wasted.to(dtype)[:, None]

    F = S // num_channels
    frames = signal.view(F, num_channels, B)
    if do_decorrelate and num_channels == 2:
        frames = torch.stack(decorrelate2(frames[:, 0], frames[:, 1],
                                          channel_code[:, None]), dim=1)
    pcm = frames.transpose(1, 2).contiguous()
    return wrap_to(pcm, {8: torch.int8, 16: torch.int16,
                         32: torch.int32}[container_bits])


# PyTorch runs eagerly: the JAX package's jitted reconstruct is its core.
reconstruct = reconstruct_core


def reconstruct_packed(buf, *, spec, class_names, num_channels: int,
                       container_bits: int, do_decorrelate: bool):
    """Single-buffer variant of reconstruct: `buf` is the int32 tensor
    of runtime/pack.py's Packer on the device, `spec` its layout and
    `class_names` the classes present (buffer entries "ci_<name>")."""
    a = unpack(buf, spec)
    class_idx = {n: a["ci_" + n] for n in class_names}
    return reconstruct_core(
        a["rows"], a["kind"], a["order"], a["wasted"], a["shift"],
        a["coeffs"], a["seeds"], class_idx, a["channel_code"],
        num_channels=num_channels, container_bits=container_bits,
        do_decorrelate=do_decorrelate)
