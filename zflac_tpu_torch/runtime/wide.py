"""64-bit values of wide pack2 chunks as int64 tensors (counterpart of
zflac_tpu/runtime/wide.py).

A chunk with a 33-bit side channel (32-bit stereo with decorrelation)
carries its warm-up samples, fixed-order seeds and patch values as a
low-word section ("warm", "seeds", "pval") and a high-word section
("warm_hi", "seeds_hi", "pval_hi") of the int32 plan buffer
(zflac_tpu/index/native_indexer.py). The JAX package keeps such values
as (hi, lo) int32 pairs and emulates 64-bit arithmetic on them; the
port joins the two words into int64 once and computes with int64
tensor ops, so the pair library has no counterpart here.
"""

from __future__ import annotations

import torch


def join_i64(hi, lo):
    """int64 values from int32 high and low words (lo read unsigned)."""
    return (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)


def split_i64(x):
    """(hi, lo) int32 words of int64 `x`, the inverse of join_i64 (lo
    as the JAX package stores it: the unsigned word bit-cast to
    int32)."""
    return (x >> 32).to(torch.int32), wrap_to(x, torch.int32)


def wrap_to(x, dtype):
    """Integer tensor `x` cast to the narrower or equal integer `dtype`
    with wraparound: the low bits, read as signed (as XLA's astype and
    bitcast of the low word give them)."""
    if x.dtype == dtype:
        return x
    bits = torch.iinfo(dtype).bits
    half = 1 << (bits - 1)
    return (((x & ((1 << bits) - 1)) ^ half) - half).to(dtype)
