"""The plain reference: PCM worked out again from what the benchmark's
encoder decided, in plain torch, with nothing of the program.

For every subframe the encoder kept its kind, predictor and residuals
(flacenc.Side). The reference runs the predictor recursion of RFC 9639
9.2.5-9.2.6 over all subframes at once, one time step at a time,

    s[i] = residual[i] + (sum_j c[j] * s[i-1-j] >> shift)   (i >= order)

with the warm-up samples before, then undoes each frame's stereo
decorrelation (9.2.3). `exact` computes in int64, as the format asks;
the control computes the same recursion with the prediction in float32,
the lower precision that a faster decoder would be tempted by.

Imports torch and numpy only: not the program, not JAX.
"""

from __future__ import annotations

import numpy as np
import torch

CH_LEFT_SIDE, CH_SIDE_RIGHT, CH_MID_SIDE = 8, 9, 10


def _recur(resid: torch.Tensor, coeffs: torch.Tensor, shift: torch.Tensor,
           order: torch.Tensor, warm: torch.Tensor, dtype) -> torch.Tensor:
    """Subframe samples [n, B] int64 from residual rows [n, B]."""
    n, B = resid.shape
    K = coeffs.shape[1]
    out = torch.empty((n, B), dtype=torch.int64, device=resid.device)
    hist = torch.zeros((n, K), dtype=torch.int64, device=resid.device)
    cf = coeffs.to(dtype)
    scale = torch.pow(2.0, shift.to(torch.float64)).to(dtype)
    active = order > 0
    for i in range(B):
        if dtype == torch.int64:
            pred = (hist * coeffs).sum(1) >> shift
        else:
            pred = torch.floor((hist.to(dtype) * cf).sum(1) / scale).long()
        s = torch.where(i < order, warm[:, min(i, K - 1)], resid[:, i] +
                        torch.where(active, pred, 0))
        out[:, i] = s
        hist = torch.cat([s[:, None], hist[:, :-1]], 1)
    return out


def _decorrelate(a: torch.Tensor, b: torch.Tensor, code: torch.Tensor):
    """Left and right of one frame batch from its two subframes."""
    code = code[:, None]
    ls = code == CH_LEFT_SIDE
    sr = code == CH_SIDE_RIGHT
    ms = code == CH_MID_SIDE
    mid = (a << 1) | (b & 1)
    left = torch.where(sr, a + b, torch.where(ms, (mid + b) >> 1, a))
    right = torch.where(ls, a - b, torch.where(ms, (mid - b) >> 1, b))
    return left, right


def decode(sides: list, channels: int, device,
           dtype=torch.int64) -> list:
    """Interleaved PCM [n, channels] int64 of each stream from its side
    information; `dtype` is the precision of the prediction. All
    subframes of all streams run as one batch, shorter blocks padded
    with zero residuals to the longest."""
    blocks = [r for side in sides for r in side.resid]
    Bmax = max(r.shape[1] for r in blocks)
    resid = np.zeros((sum(r.shape[0] for r in blocks), Bmax), np.int32)
    at = 0
    for r in blocks:
        resid[at:at + r.shape[0], :r.shape[1]] = r
        at += r.shape[0]
    cat = lambda key: torch.as_tensor(np.concatenate(
        [getattr(s, key) for s in sides]), device=device)
    x = _recur(torch.as_tensor(resid, device=device).long(), cat("coeffs"),
               cat("shift"), cat("order"), cat("warm"), dtype)
    del resid
    code = cat("chcode")
    out, at, f_at = [], 0, 0
    for side in sides:
        parts = []
        for r in side.resid:
            S, B = r.shape
            F = S // channels
            xs = x[at:at + S, :B].view(F, channels, B)
            if channels == 2:
                left, right = _decorrelate(xs[:, 0], xs[:, 1],
                                           code[f_at:f_at + F])
                xs = torch.stack([left, right], 1)
            parts.append(xs.permute(0, 2, 1).reshape(-1, channels).cpu())
            at += S
            f_at += F
        out.append(torch.cat(parts).numpy())
    return out


def output_domain(pcm: np.ndarray, bps: int, normalized: bool) -> np.ndarray:
    """The reference PCM in the domain an entry returns: as decoded (the
    MD5 domain), or normalized to its container's most significant
    bits (9-15-bit audio fills 16 bits, 17-31-bit audio fills 32),
    wrapping in the container as the decoders' output contract does."""
    if not normalized:
        return pcm
    shift = 16 - bps if 9 <= bps <= 15 else 32 - bps if 17 <= bps <= 31 else 0
    if not shift:
        return pcm
    bits = 16 if bps <= 16 else 32
    out = (pcm << shift) & ((1 << bits) - 1)
    return np.where(out >= 1 << (bits - 1), out - (1 << bits), out)
