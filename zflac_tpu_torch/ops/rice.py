"""Reference math for the measured-offset Rice group table, in plain
PyTorch on an explicit device (counterpart of zflac_tpu/ops/rice.py).

The C++ scan records, with emit_groups, each Rice group's bit offset,
parameter and escape depth (index/native_indexer.py
`build_plan_native`). `rows_from_groups` decodes the residual rows from
those offsets and the bitstream's windows and must give the scan's own
host rows: the differential check of the group-recording walk that the
pack2 scan shares with rice16. There is no kernel here: the JAX module
has no Pallas call either; the production extraction is rice16.

torch has no uint32 arithmetic on the CPU, so the uint32 math runs in
int64 on values masked to 32 bits. Shifts follow XLA's rules: a logical
shift by 32 or more gives 0, an arithmetic one the sign fill.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.device import resolve_device

G = 8           # residuals per group (indexer kGroupG)
W = 12          # window words per group (kGroupWindowWords)
K_ESCAPE = 0xFE
K_INVALID = 0xFF
_M32 = 0xFFFFFFFF


def _shr(u, s):
    """uint32 u >> s (both int64 tensors, u in [0, 2**32)); 0 for an
    amount outside 0..31, as XLA gives."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, u >> s.clamp(0, 31), 0)


def _shl(u, s):
    """uint32 u << s, wrapped to 32 bits; 0 outside 0..31."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (u << s.clamp(0, 31)) & _M32, 0)


def bitcast_i32(u):
    """The int32 whose two's-complement bits are uint32 u (int64)."""
    return (((u + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _clz32(u):
    """Count leading zeros of uint32 values (int64 tensor, exact): smear
    the MSB down, then a SWAR popcount."""
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    v = u - ((u >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    pop = ((v * 0x01010101) & _M32) >> 24
    return (32 - pop).to(torch.int32)


def _select_word(win, wi, c_lo: int, c_hi: int):
    """win[wi] per lane for wi in [c_lo, c_hi] by a select chain, else
    0 (win: [W, L] uint32 values in int64; wi: [1, L] int32)."""
    acc = torch.zeros_like(win[0:1])
    for c in range(c_lo, c_hi + 1):
        acc = torch.where(wi == c, win[c:c + 1], acc)
    return acc


def _extract64(win, pos, max_word: int):
    """(chunk, chunk2): two consecutive MSB-first 32-bit big-endian
    chunks starting at bit `pos` of the lane's window."""
    wi = pos >> 5
    b = (pos & 31).long()
    w0 = _select_word(win, wi, 0, max_word)
    w1 = _select_word(win, wi + 1, 1, min(max_word + 1, W - 1))
    w2 = _select_word(win, wi + 2, 2, min(max_word + 2, W - 1))
    # (x >> 1) >> (31 - b) == x >> (32 - b), defined for b == 0.
    chunk = _shl(w0, b) | ((w1 >> 1) >> (31 - b))
    chunk2 = _shl(w1, b) | ((w2 >> 1) >> (31 - b))
    return chunk, chunk2


def _unpack_math(win, pos0, k, depth, skip):
    """Group extraction. win [W, L] uint32 values in int64; pos0, k,
    depth, skip [1, L] int32. Returns [G, L] int32."""
    valid = k != K_INVALID
    is_escape = k == K_ESCAPE
    kk = torch.where(is_escape | ~valid, 0, k).long()

    pos = pos0
    outs = []
    for j in range(G):
        active = valid & (j >= skip)
        chunk, chunk2 = _extract64(win, pos, W - 2)

        # Rice path: unary quotient (q <= 40, guaranteed by the scan).
        q = torch.where(chunk != 0, _clz32(chunk), 32 + _clz32(chunk2))
        rem_chunk, _ = _extract64(win, pos + q + 1, W - 1)
        rem = torch.where(kk > 0, _shr(rem_chunk >> 1, 31 - kk), 0)
        zz = _shl(q.long(), kk) | rem
        # Zigzag decode in uint32 wraparound == the int32 bit pattern.
        rice_val = bitcast_i32((zz >> 1) ^ ((0 - (zz & 1)) & _M32))
        rice_adv = q + 1 + kk.to(torch.int32)

        # Escape path: a fixed-width signed residual, sign-extended by
        # an arithmetic shift of the chunk's int32 view.
        esc_shift = (32 - depth).clamp(max=31).long()
        esc_i32 = bitcast_i32(chunk).long()
        esc_sh = torch.where((esc_shift >= 0) & (esc_shift < 32),
                             esc_i32 >> esc_shift.clamp(0, 31),
                             esc_i32 >> 31).to(torch.int32)
        esc_val = torch.where(depth > 0, esc_sh, 0)

        value = torch.where(is_escape, esc_val, rice_val)
        adv = torch.where(is_escape, depth, rice_adv)
        outs.append(torch.where(active, value, 0).to(torch.int32))
        pos = torch.where(active, pos + adv, pos)
    return torch.cat(outs, dim=0)


def build_group_inputs(data: bytes, plan):
    """Gather per-group bit windows + per-lane metadata from the plan's
    group table (numpy, vectorized). Returns (windows [W, NG] uint32,
    pos0, k, depth, skip [1, NG] i32, valid_mask [S, GPB] bool) with
    NG = S * GPB."""
    g = plan.groups
    if g is None:
        raise ValueError("plan built without emit_groups")
    off = g["off"]                      # [S, GPB] i64
    S, GPB = off.shape

    # Bitstream as big-endian u32 words, padded so that a full window
    # gather at the last group stays in bounds.
    pad = (-len(data)) % 4 + 4 * (W + 1)
    words = np.frombuffer(data + b"\x00" * pad, dtype=">u4")

    flat_off = off.reshape(-1)
    valid = (g["k"].reshape(-1) != K_INVALID) & (flat_off >= 0)
    word_idx = np.where(valid, flat_off >> 5, 0).astype(np.int64)
    # [NG, W] gather of each group's window.
    win = words[word_idx[:, None] + np.arange(W)[None, :]]
    win = np.ascontiguousarray(win.astype(np.uint32).T)   # [W, NG]

    pos0 = np.where(valid, flat_off & 31, 0).astype(np.int32)
    k = np.where(valid, g["k"].reshape(-1), K_INVALID).astype(np.int32)
    depth = g["depth"].reshape(-1).astype(np.int32)

    # skip: leading warm-up positions in the first recorded group.
    order = plan.order                  # [S]
    gidx = np.tile(np.arange(GPB)[None, :], (S, 1))
    skip = np.clip(order[:, None] - gidx * G, 0, G).astype(np.int32)
    skip = skip.reshape(-1)

    return (win, pos0[None, :], k[None, :], depth[None, :],
            skip[None, :], valid.reshape(S, GPB))


def rows_from_groups(data: bytes, plan, *, device="cuda"):
    """Residual rows decoded on `device` from the bitstream windows by
    the group-table math, with the host patching invalid groups and
    warm-up positions. Returns [S, B] int32 rows (numpy) equal to
    plan.rows in the int32 wrap domain (the differential check for the
    C++ group scan)."""
    device = resolve_device(device)
    if plan.groups is None:
        # No Rice-coded subframes (constant/verbatim-only stream).
        return plan.rows.astype(np.int32)
    win, pos0, k, depth, skip, valid = build_group_inputs(data, plan)
    S, GPB = valid.shape

    def t(a):
        return torch.as_tensor(a, device=device)

    out = _unpack_math(t(win.astype(np.int64)), t(pos0), t(k), t(depth),
                       t(skip))
    out = out.cpu().numpy()                         # [G, S * GPB]
    rows = out.T.reshape(S, GPB * G)[:, :plan.max_block]

    # Patch invalid groups + warm-up region from the host rows, and
    # zero the padding past each subframe's block size (a short final
    # group decodes past the subframe into the next one's bits).
    col = np.arange(plan.max_block)[None, :]
    group_valid = np.repeat(valid, G, axis=1)[:, :plan.max_block]
    host_rows = plan.rows.astype(np.int32)
    bs_sub = np.repeat(plan.block_size, plan.channels)[:, None]
    rows = np.where(col < plan.order[:, None], host_rows,
                    np.where(group_valid, rows, host_rows))
    return np.where(col < bs_sub, rows, 0)
