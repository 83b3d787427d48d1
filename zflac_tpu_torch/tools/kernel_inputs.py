"""Seeded inputs for the streaming kernels, rice16 and packtail, beyond
what real streams reach. The CPU tests feed them to the JAX package and
to the plain versions (tests/test_torch_ops.py); chip_smoke.py feeds
them to the kernels and the plain versions on the card. numpy only.
"""

from __future__ import annotations

import numpy as np

K2_ESCAPE = 62    # ops/rice16.py: k of an escaped partition
K2_INVALID = 63   # and of an invalid group (patched from the scan)
STEREO_CODES = (1, 8, 9, 10)  # independent, left-side, side-right, mid-side


def rice_groups(rng, W: int, NG: int, adversarial: bool = False):
    """Window words [W, NG] uint32 and meta words [NG] int32 for NG
    group slots: pos0 0-31, depth 0-31, Rice, escape, invalid and skip
    groups. The default mode draws k from 0-31 with 10 % escapes and
    10 % invalid groups, and skips (1-8) in 5 % of the groups.
    `adversarial` draws the whole 6-bit k (0-63, so Rice parameters
    past 32 too), skips of 0-8 in every group, and for half the groups
    sparse windows (one bit in 16 set, and every tenth group all zero),
    so that unary runs cross words and run past the TPU kernel's bound
    on the read position."""
    win = rng.integers(0, 1 << 32, (W, NG), dtype=np.uint32)
    if adversarial:
        k6 = rng.integers(0, 64, NG)
        k6[rng.random(NG) < 0.05] = K2_ESCAPE
        k6[rng.random(NG) < 0.05] = K2_INVALID
        sparse = rng.random(NG) < 0.5
        thin = win
        for _ in range(3):
            thin = thin & rng.integers(0, 1 << 32, (W, NG), dtype=np.uint32)
        win = np.where(sparse[None, :], thin, win)
        win[:, rng.random(NG) < 0.1] = 0
        skip = rng.integers(0, 9, NG)
    else:
        k6 = rng.integers(0, 32, NG)
        k6[rng.random(NG) < 0.1] = K2_ESCAPE
        k6[rng.random(NG) < 0.1] = K2_INVALID
        skip = None
    depth = rng.integers(0, 32, NG)
    if skip is None:
        skip = np.where(rng.random(NG) < 0.05, rng.integers(0, 9, NG), 0)
    pos0 = rng.integers(0, 32, NG)
    meta = (pos0 | (k6 << 5) | (depth << 11) | (skip << 16)).astype(np.int32)
    return win, meta


def packtail_inputs(rng, Fp: int, Bp: int):
    """(stack [2 * Fp + 1, Bp], inv [2 * Fp], wasted [2 * Fp], chcode
    [Fp]), all int32: stack values over the whole int32 range, so the
    shifts and sums wrap; inv a permutation of the rows (one row
    unused); wasted amounts from -3 to 40, most of them in 0-31, the
    rest outside the 5-bit field, where the shift gives 0; every stereo
    channel code."""
    rows = 2 * Fp + 1
    stack = rng.integers(-(1 << 31), 1 << 31, (rows, Bp), dtype=np.int64)
    inv = rng.permutation(rows)[:2 * Fp]
    wasted = rng.integers(-3, 41, 2 * Fp)
    chcode = rng.choice(STEREO_CODES, Fp)
    return tuple(a.astype(np.int32) for a in (stack, inv, wasted, chcode))
