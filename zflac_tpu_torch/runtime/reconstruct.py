"""Batched signal reconstruction (counterpart of
zflac_tpu/runtime/reconstruct.py).

Fixed-predictor integration and stereo decorrelation in the pack2
time-major layout (counterparts of _fixed_integrate_t, of the
decorrelation in zflac_tpu/runtime/device.py and of their 64-bit pair
twins in zflac_tpu/runtime/wide.py), and the rows engine's core, which
turns the dense plan arrays into PCM: const broadcast, verbatim, the
fixed and lpc classes in one launch of the lpc kernel (lpc64 on int64
rows), the widened `lpc_wide` class in lpc64, then the wasted shift,
the decorrelation and the container cast. A fixed predictor is an LPC
predictor with shift 0 and constant coefficients (FIXED_COEFFS), so
the core runs no cumsum; fixed_integrate and fixed_integrate_t, the
JAX package's seeded cumsums, stay as the tests' reference.

Everything runs in the dtype of its inputs: int32 on the int32 path,
int64 on wide chunks and 17-32-bit streams, where the JAX package
carries (hi, lo) int32 pairs or runs under x64. Apart from the LPC
kernel these stay plain tensor ops: the JAX package leaves them to XLA,
not to a Pallas kernel.
"""

from __future__ import annotations

import functools

import torch

from .. import format as fmt
from ..ops.lpc import HIST, clamp_shift, lpc_reconstruct
from ..utils.timer import count
from .pack import unpack
from .scatter import gather_rows, put_rows_, row_index
from .wide import wrap_to

# The fixed predictors of orders 0-4 (RFC 9639 section 9.2.5) as LPC
# coefficients: entry k holds c_1..c_k of order k, s[t] = residual +
# sum c_j s[t-j]. Exact in any wrapping sum, as the k-fold cumsum is.
FIXED_COEFFS = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))


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


@functools.cache
def _fixed_table(device: torch.device, reverse: bool):
    """FIXED_COEFFS as a constant int32 table on `device`, column k the
    coefficients of order k: [8, 5] with row r = c_{r+1} (the forward
    hist-8 layout of pack2's LPC kernels), or with `reverse` [32, 5]
    with row 31 - j multiplying s[t-1-j] (the rows engine's lpc
    kernel). Made once a device and layout, so that no chunk or plan
    pays a host-to-device copy for it."""
    hist = HIST if reverse else 8
    host = torch.zeros((hist, len(FIXED_COEFFS)), dtype=torch.int32)
    for k, coeffs in enumerate(FIXED_COEFFS):
        if reverse:
            host[hist - k:, k] = torch.tensor(coeffs[::-1],
                                              dtype=torch.int32)
        else:
            host[:k, k] = torch.tensor(coeffs, dtype=torch.int32)
    return host.to(device)


def fixed_coeffs(order, *, reverse: bool):
    """The LPC coefficients [hist, n] int32 of fixed lanes of these
    orders [n], in _fixed_table's layout: one gather from the table. An
    order outside 0-4, which no scan or indexer writes, reads as the
    nearest, as fixed_integrate_t treats it."""
    return _fixed_table(order.device, reverse).index_select(
        1, torch.clamp(order, 0, len(FIXED_COEFFS) - 1))


def lpc_lanes_inputs(rows, coeffs_rev, shift, order, fixed_idx, lpc_idx):
    """The lpc kernel's time-major arguments for one launch over the
    fixed class's lanes (padded gather list fixed_idx) followed by the
    lpc class's (lpc_idx); either list may be None. A fixed subframe of
    order k is an LPC subframe with the coefficients FIXED_COEFFS[k] and
    shift 0: the plan holds its raw warm-ups at t < order and its
    residuals after, and its shift 0, so only its coefficients come from
    elsewhere (fixed_coeffs). Returns (the joined gather list, (rows
    [B, n], coeffs [32, n], shift [n], order [n]))."""
    if fixed_idx is None:
        idx = lpc_idx
    elif lpc_idx is None:
        idx = fixed_idx
    else:
        idx = torch.cat([fixed_idx, lpc_idx])
    gi = row_index(idx, rows.shape[0])
    order_g = order[gi]
    n_fixed = 0 if fixed_idx is None else fixed_idx.shape[0]
    coeffs = []
    if fixed_idx is not None:
        coeffs.append(fixed_coeffs(order_g[:n_fixed], reverse=True))
    if lpc_idx is not None:
        coeffs.append(coeffs_rev[gi[n_fixed:]].t())
    coeffs_t = (torch.cat(coeffs, dim=1) if len(coeffs) > 1
                else coeffs[0].contiguous())
    rows_t = torch.index_select(rows.t(), 1, gi).contiguous()
    return idx, (rows_t, coeffs_t, shift[gi], order_g)


def reconstruct_core(rows, order, wasted, shift, coeffs_rev, class_idx,
                     channel_code, *, num_channels: int, container_bits: int,
                     do_decorrelate: bool):
    """Plan tensors -> container-width PCM [F, B, C] (pre-normalization)
    on their device. rows [S, B] int32 or int64; class_idx: name ->
    padded int32 gather list whose entries >= S are sentinels. The JAX
    core also takes the plan's kind and fixed seeds; here the class
    lists carry the kind, and the fixed rows' warm-ups replace their
    seeds (lpc_lanes_inputs). Counts `fixed_own_launches` in the open
    call (1 where the fixed class had no lpc class to share a launch
    with)."""
    S, B = rows.shape
    dtype = rows.dtype
    # Every class writes in place into one canvas whose dead row S takes
    # the sentinels' writes (scatter.py put_rows_), dropped at the shift.
    signal = torch.zeros((S + 1, B), dtype=dtype, device=rows.device)

    idx = class_idx.get("const")
    if idx is not None:
        vals = gather_rows(rows, idx)[:, 0:1].expand(idx.shape[0], B)
        put_rows_(signal, idx, vals)

    idx = class_idx.get("verbatim")
    if idx is not None:
        put_rows_(signal, idx, gather_rows(rows, idx))

    # The fixed class runs as lanes of the lpc class's launch, or in a
    # launch of its own where the plan has no lpc class.
    fixed, lpc = class_idx.get("fixed"), class_idx.get("lpc")
    if fixed is not None or lpc is not None:
        idx, args = lpc_lanes_inputs(rows, coeffs_rev, shift, order, fixed,
                                     lpc)
        put_rows_(signal, idx, lpc_reconstruct(*args).t())
        del args                # the gathered rows: not held to the end
    count("fixed_own_launches", int(fixed is not None and lpc is None))

    idx = class_idx.get("lpc_wide")
    if idx is not None:
        # An int32 stream's class whose accumulator may pass 32 bits:
        # lpc64 (the reference's InterType widening, zflac.zig:314-319),
        # then back to the stream dtype with wraparound.
        _, args = lpc_lanes_inputs(rows, coeffs_rev, shift, order, None,
                                   idx)
        args = (args[0].long(), *args[1:])
        put_rows_(signal, idx, wrap_to(lpc_reconstruct(*args).t(), dtype))
        del args

    # Wasted-bits shift (zflac.zig:447,459,495-496,538-539).
    signal = signal[:S] << wasted.to(dtype)[:, None]

    F = S // num_channels
    frames = signal.view(F, num_channels, B)
    if do_decorrelate and num_channels == 2:
        frames = torch.stack(decorrelate2(frames[:, 0], frames[:, 1],
                                          channel_code[:, None]), dim=1)
    pcm = frames.transpose(1, 2).contiguous()
    return wrap_to(pcm, {8: torch.int8, 16: torch.int16,
                         32: torch.int32}[container_bits])


def reconstruct_packed(buf, *, spec, class_names, num_channels: int,
                       container_bits: int, do_decorrelate: bool):
    """reconstruct_core on one packed buffer: `buf` is the int32 tensor
    of runtime/pack.py's Packer on the device, `spec` its layout and
    `class_names` the classes present (buffer entries "ci_<name>")."""
    a = unpack(buf, spec)
    class_idx = {n: a["ci_" + n] for n in class_names}
    return reconstruct_core(
        a["rows"], a["order"], a["wasted"], a["shift"], a["coeffs"],
        class_idx, a["channel_code"], num_channels=num_channels,
        container_bits=container_bits, do_decorrelate=do_decorrelate)
