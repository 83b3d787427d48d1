"""rice16: residuals out of the scan's per-group bit windows, as
time-major rows (counterpart of zflac_tpu/ops/rice16.py
rice16_unpack_rows_inline; kernel in csrc/rice16.cu), and in the flat
layout [G2, NG] (counterpart of rice16_unpack_inline, the same kernel
with one p-row).

Each group of G2 = 8 residuals carries W window words (W = 8, or 16
for extreme Rice parameters) and one meta word packing pos0:5 | k:6 |
depth:5 | skip:5, with k 62 marking an escaped partition and 63 an
invalid group (written as zeros and patched later from the scan's
values). Group slots are p-major (slot = p * Ssort + sorted subframe),
so residual j of slot (p, s) lands at time row p * G2 + j, lane s.
"""

from __future__ import annotations

import torch

from .. import _kernels

G2 = 8  # must match kG2 in zflac_tpu/index/native/pack2_helpers.inc
K2_ESCAPE = 62
K2_INVALID = 63

_M32 = 0xFFFFFFFF


def _clz32(u):
    """Leading zeros of uint32 values held in int64 (0 -> 32)."""
    n = torch.zeros_like(u)
    for bits in (16, 8, 4, 2, 1):
        top = u >> (32 - bits) == 0      # the top `bits` bits are zero
        n = n + top * bits
        u = torch.where(top, (u << bits) & _M32, u)
    return n + (u == 0)


def rice16_unpack_rows_ref(win, meta, *, Ssort: int):
    """Plain PyTorch version of the rice16 kernel. win: [W, NGp] int32
    (the uint32 window bits), meta: [NGp] int32, NGp a multiple of
    Ssort. Returns [(NGp // Ssort) * G2, Ssort] int32.

    uint32 tensors have no shifts or sums on the CPU, so the uint32
    math of the kernel runs here in int64 on values in [0, 2**32),
    masked after every left shift; shifts the kernel defines as 0 for
    amounts of 32 or more are written as such."""
    W, NGp = win.shape
    GP1 = NGp // Ssort
    w64 = win.to(torch.int64) & _M32
    m = meta.to(torch.int64)
    pos = m & 31
    k6 = (m >> 5) & 63
    depth = (m >> 11) & 31
    skip = (m >> 16) & 31

    valid = k6 != K2_INVALID
    is_escape = k6 == K2_ESCAPE
    kk = torch.where(is_escape | ~valid, 0, k6)
    du = torch.clamp(32 - depth, max=31)
    # Escaped value: the chunk read as int32, arithmetic-shifted by du.
    outs = []
    for j in range(G2):
        active = valid & (j >= skip)
        wi = pos >> 5
        b = pos & 31
        hi = min((31 + 64 * j) >> 5, W - 3)
        if hi == 0:
            w0, w1, w2 = w64[0], w64[1], w64[2]
        else:
            # Words past the bound read as 0, as the TPU select chain.
            inb = wi <= hi
            idx = torch.clamp(wi, max=hi)[None]
            w0 = torch.where(inb, w64.gather(0, idx)[0], 0)
            w1 = torch.where(inb, w64.gather(0, idx + 1)[0], 0)
            w2 = torch.where(inb, w64.gather(0, idx + 2)[0], 0)
        chunk = ((w0 << b) & _M32) | ((w1 >> 1) >> (31 - b))
        chunk2 = ((w1 << b) & _M32) | ((w2 >> 1) >> (31 - b))

        zeros = torch.where(chunk != 0, _clz32(chunk), 32 + _clz32(chunk2))
        sh = torch.clamp(zeros + 1, max=41)
        sh_lo = torch.clamp(sh, max=31)
        fhi = torch.where(
            sh < 32,
            ((chunk << sh_lo) & _M32) | ((chunk2 >> 1) >> (31 - sh_lo)),
            (chunk2 << (sh & 31)) & _M32)
        rs = (32 - kk) & _M32                 # uint32 wrap for kk > 32
        rem = torch.where((kk > 0) & (rs < 32),
                          fhi >> torch.clamp(rs, max=31), 0)
        q_sh = torch.where(kk < 32, (zeros << torch.clamp(kk, max=31)) & _M32,
                           0)
        zz = q_sh | rem
        rice_u = (zz >> 1) ^ ((-(zz & 1)) & _M32)
        rice_val = rice_u - ((rice_u >> 31) << 32)   # int32 bit pattern
        rice_adv = zeros + 1 + kk

        chunk_s = chunk - ((chunk >> 31) << 32)
        esc_val = torch.where(depth > 0, chunk_s >> du, 0)

        value = torch.where(is_escape, esc_val, rice_val)
        adv = torch.where(is_escape, depth, rice_adv)
        outs.append(torch.where(active, value, 0).to(torch.int32))
        pos = torch.where(active, pos + adv, pos)
    out = torch.stack(outs)                    # [G2, NGp]
    return out.view(G2, GP1, Ssort).transpose(0, 1).reshape(GP1 * G2, Ssort)


def rice16_unpack_rows(win, meta, *, Ssort: int):
    """rice16 on the device of its inputs: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Shapes as
    rice16_unpack_rows_ref; win must be contiguous [W, NGp] with W 8 or
    16, meta contiguous [NGp]."""
    if _kernels.route(win, meta) == "cpu":
        return rice16_unpack_rows_ref(win, meta, Ssort=Ssort)
    return _launch("rice16", win, meta, Ssort)


def rice16_unpack_ref(win, meta):
    """Plain PyTorch version of the flat layout (counterpart of
    zflac_tpu/ops/rice16.py rice16_unpack_inline): win [W, NG] int32,
    meta [NG] int32 -> [G2, NG] int32, residual j of group g at [j, g].
    It is the rows layout with one p-row, Ssort = NG."""
    if win.shape[1] == 0:
        return win.new_empty((G2, 0))
    return rice16_unpack_rows_ref(win, meta, Ssort=win.shape[1])


def rice16_unpack(win, meta):
    """The flat layout on the device of its inputs: the rice16 kernel
    with Ssort = NG (launch counted as rice16_flat) for CUDA tensors,
    rice16_unpack_ref for CPU tensors. W must be 8 or 16: the scan
    writes no other window width."""
    if _kernels.route(win, meta) == "cpu":
        return rice16_unpack_ref(win, meta)
    return _launch("rice16_flat", win, meta, win.shape[1])


def _launch(name, win, meta, Ssort):
    """Check the arguments of the rice16 kernel and launch it on CUDA
    tensors, counted under `name` (rice16 or rice16_flat)."""
    W, NGp = win.shape
    if W not in (8, 16):
        raise ValueError(f"{name}: window of {W} words (kernel takes 8, 16)")
    # The flat layout of no group has Ssort = NG = 0: one empty p-row.
    p_rows = NGp // Ssort if Ssort > 0 else 1
    if p_rows * Ssort != NGp:
        raise ValueError(f"{name}: NGp {NGp} is not a multiple of Ssort "
                         f"{Ssort}")
    _kernels.check(win, "win", torch.int32)
    _kernels.check(meta, "meta", torch.int32, shape=(NGp,))
    out = torch.empty((p_rows * G2, Ssort), dtype=torch.int32,
                      device=win.device)
    if NGp == 0:
        return out
    _kernels.launch(name, win.device, win.data_ptr(), meta.data_ptr(),
                    out.data_ptr(), W, NGp, Ssort)
    return out
