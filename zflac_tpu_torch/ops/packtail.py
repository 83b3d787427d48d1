"""packtail: stereo stream-order gather + wasted-bits shift +
decorrelation + channel pack (counterpart of
zflac_tpu/ops/packtail.py packtail_inline; kernel in
csrc/packtail.cu). Serves the stereo 8- and 16-bit containers.

For frame f, stack rows inv[2f] and inv[2f+1] are shifted left by
their wasted bits, decorrelated by chcode[f] (left-side, side-right,
mid-side; zflac.zig:553-578) and packed two channels to a word,
channel 0 in the low half: int32 (c0 & 0xFFFF) | (c1 << 16) for the
16-bit container, int16 (c0 & 0xFF) | ((c1 & 0xFF) << 8) for the 8-bit
one. Viewing the [Fp, Bp] result as int16 (int8) appends the channel
axis in memory order, as the JAX package's bitcast does.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .. import format as fmt


def _out_dtype(container_bits: int):
    if container_bits == 16:
        return torch.int32
    if container_bits == 8:
        return torch.int16
    raise ValueError(f"packtail: container {container_bits} (takes 8, 16)")


def packtail_ref(stack, inv, wasted, chcode, *, Fp: int,
                 container_bits: int):
    """Plain PyTorch version of the packtail kernel. stack: [rows, Bp]
    int32; inv, wasted: [2 * Fp] int32; chcode: [Fp] int32. Returns
    [Fp, Bp] int32 (container 16) or int16 (container 8). Row indices
    are clamped into the stack, as the kernel clamps them."""
    dtype = _out_dtype(container_bits)
    rows = stack.shape[0]
    inv = torch.clamp(inv[:2 * Fp], 0, rows - 1).long()
    c0 = stack[inv[0::2]] << wasted[0:2 * Fp:2, None]
    c1 = stack[inv[1::2]] << wasted[1:2 * Fp:2, None]
    mode = chcode[:Fp, None]
    mid = (c0 << 1) | (c1 & 1)
    new0 = torch.where(
        mode == fmt.CH_SIDE_RIGHT, c0 + c1,
        torch.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
    new1 = torch.where(
        mode == fmt.CH_LEFT_SIDE, c0 - c1,
        torch.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
    if container_bits == 16:
        return (new0 & 0xFFFF) | (new1 << 16)
    return ((new0 & 0xFF) | ((new1 & 0xFF) << 8)).to(dtype)


def packtail(stack, inv, wasted, chcode, *, Fp: int, container_bits: int):
    """packtail on the device of its inputs: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Shapes as packtail_ref;
    the kernel takes contiguous int32 inputs."""
    if _kernels.route(stack, inv, wasted, chcode) == "cpu":
        return packtail_ref(stack, inv, wasted, chcode, Fp=Fp,
                            container_bits=container_bits)
    dtype = _out_dtype(container_bits)
    rows, Bp = stack.shape
    _kernels.check(stack, "stack", torch.int32)
    _kernels.check(inv, "inv", torch.int32, shape=(2 * Fp,))
    _kernels.check(wasted, "wasted", torch.int32, shape=(2 * Fp,))
    _kernels.check(chcode, "chcode", torch.int32, shape=(Fp,))
    out = torch.empty((Fp, Bp), dtype=dtype, device=stack.device)
    if Fp == 0 or Bp == 0:
        return out
    _kernels.launch("packtail", stack.device, stack.data_ptr(), rows, Bp,
                    inv.data_ptr(), wasted.data_ptr(), chcode.data_ptr(),
                    out.data_ptr(), Fp, container_bits)
    return out
