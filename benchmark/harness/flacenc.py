"""The benchmark's own FLAC encoder, vectorised across frames in torch.

Frozen, and independent of the program: it takes the program's
`encoder.py` as its pattern (the same RFC 9639 fields in the same
order) but decides and writes every frame of a stream at once, on the
device it is given:

- each stereo frame is analysed as L, R, mid and side, and the cheapest
  pair of the four channel assignments is kept (`flac -m`);
- a subframe is constant when its block is, else the cheapest of
  verbatim, the best fixed order (0-4, by summed |residual|) and LPC:
  Tukey(0.5)-windowed autocorrelation, batched Levinson-Durbin, the
  order by libFLAC's expected-bits estimate, coefficients quantised
  with error feedback at the configured precision;
- Rice parameters are exhaustive: every partition order up to the
  configured maximum, every parameter, both coding methods;
- every field becomes a (width, value) slot, slots get their bit
  offsets from cumulative sums and are added into 32-bit words;
- CRC-8 runs over all frame headers at once, one byte a step, and
  CRC-16 over every frame of every stream of a pool at once, eight
  bytes a step.

`encode` returns the stream's bytes and the side information that the
plain reference (reference.py) reconstructs the PCM from, and the
per-stream counts that the roofline files read.
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

# Fixed predictors as LPC coefficients on s[i-1-j] (RFC 9639 9.2.5).
FIXED = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))
MAX_ORDER = 8                  # slots reserved for warm-ups and coefficients
K_MAX = (14, 20)               # Rice parameters tried by method 0 and 1
SR_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
           24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
BS_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
           1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
CH_LEFT_SIDE, CH_SIDE_RIGHT, CH_MID_SIDE = 8, 9, 10
KIND_CONST, KIND_VERBATIM, KIND_FIXED, KIND_LPC = 0, 1, 2, 3
VENDOR = b"reference libFLAC 1.4.3 20230623"


def _crc_table(poly: int, width: int) -> list:
    top, mask = 1 << (width - 1), (1 << width) - 1
    out = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        out.append(crc & mask)
    return out


CRC8 = _crc_table(0x07, 8)
CRC16 = _crc_table(0x8005, 16)


def _crc16_tables(device) -> tuple:
    """CRC-16 tables on `device`: T8, the byte table; A[k], the register
    after a 16-bit word v and then 2k zero bytes, from a zero register.
    For a 16-bit register two message bytes advance it as
    r' = A[0][r ^ w], and by linearity eight bytes (words w0..w3) as
    r' = A[3][r ^ w0] ^ A[2][w1] ^ A[1][w2] ^ A[0][w3]."""
    t8 = torch.tensor(CRC16, dtype=torch.int64, device=device)
    v = torch.arange(1 << 16, dtype=torch.int64, device=device)
    r = t8[v >> 8]
    pair = t8[((r >> 8) ^ (v & 255)) & 255] ^ ((r << 8) & 0xFFFF)
    tables = [pair]
    for _ in range(3):
        tables.append(pair[tables[-1]])
    return t8, tables


@dataclass
class Side:
    """What the reference needs of one stream, on the host: per
    subframe (frame-major, channel-minor) its kind, order, shift, LPC
    coefficients on s[i-1-j], warm-up samples and residuals (the samples
    themselves for constant and verbatim subframes, whose order is 0),
    and per frame its block size and channel code."""
    block: np.ndarray          # [F] int64
    chcode: np.ndarray         # [F] int64
    kind: np.ndarray           # [S] int64
    order: np.ndarray          # [S] int64
    shift: np.ndarray          # [S] int64
    coeffs: np.ndarray         # [S, 8] int64
    warm: np.ndarray           # [S, 8] int64
    resid: list                # per frame-size batch: [S_b, B_b] int32
    counts: dict = field(default_factory=dict)


def _tukey(n: int, p: float, device) -> torch.Tensor:
    """Tukey window of n points with taper share p."""
    w = torch.ones(n, dtype=torch.float64, device=device)
    m = int(p / 2 * (n - 1))
    if m > 0:
        i = torch.arange(m + 1, dtype=torch.float64, device=device)
        ramp = 0.5 - 0.5 * torch.cos(math.pi * i / m)
        w[:m + 1] = ramp
        w[n - m - 1:] = ramp.flip(0)
    return w


def _zigzag(r: torch.Tensor) -> torch.Tensor:
    return (r << 1) ^ (r >> 63)


def _rice_plan(r: torch.Tensor, order: torch.Tensor, max_po: int):
    """Exhaustive Rice coding of residual rows r [n, B] (int64, valid
    from index `order`): returns (bits [n], method [n], po [n],
    params [n, 2**P]) with P the largest partition order tried; the
    residual section's bits include method, order and parameters."""
    n, B = r.shape
    dev = r.device
    P = 0
    while P < max_po and B % (1 << (P + 1)) == 0:
        P += 1
    idx = torch.arange(B, device=dev)[None, :]
    valid = idx >= order[:, None]
    zz = torch.where(valid, _zigzag(r), 0)
    parts = 1 << P
    cnt = valid.view(n, parts, B >> P).sum(2)
    kmax = max(K_MAX)
    sums = torch.stack([(zz >> k).view(n, parts, B >> P).sum(2)
                        for k in range(kmax + 1)])            # [K, n, parts]
    best = None
    for p in range(P, -1, -1):
        if p < P:
            sums = sums[..., 0::2] + sums[..., 1::2]
            cnt = cnt[:, 0::2] + cnt[:, 1::2]
        ks = torch.arange(kmax + 1, device=dev)[:, None, None]
        cost = sums + cnt[None] * (1 + ks)                   # [K, n, parts_p]
        # A partition order needs blocks longer than the predictor order.
        allowed = (B >> p) > order
        for method in (0, 1):
            c = cost[:K_MAX[method] + 1]
            kbest = c.argmin(0)
            bits = 6 + c.min(0).values.sum(1) + (4 + method) * (1 << p)
            bits = torch.where(allowed, bits, torch.iinfo(torch.int64).max)
            par = kbest.repeat_interleave(1 << (P - p), dim=1)
            cand = (bits, torch.full_like(bits, method),
                    torch.full_like(bits, p), par)
            if best is None:
                best = cand
            else:
                take = cand[0] < best[0]
                best = tuple(torch.where(take[:, None] if b.dim() == 2
                                         else take, c_, b)
                             for c_, b in zip(cand, best))
    return best


def _levinson(autoc: torch.Tensor, max_order: int):
    """Batched Levinson-Durbin (libFLAC's lpc_compute_lp_coefficients):
    autoc [n, max_order+1] -> (coefficients [n, max_order, max_order]
    on s[i-1-j] for each order, errors [n, max_order])."""
    n = autoc.shape[0]
    dev = autoc.device
    lpc = torch.zeros((n, max_order), dtype=torch.float64, device=dev)
    out = torch.zeros((n, max_order, max_order), dtype=torch.float64,
                      device=dev)
    errs = torch.zeros((n, max_order), dtype=torch.float64, device=dev)
    err = autoc[:, 0].clone()
    for i in range(max_order):
        r = -autoc[:, i + 1]
        for j in range(i):
            r = r - lpc[:, j] * autoc[:, i - j]
        r = torch.where(err > 0, r / torch.where(err > 0, err, 1.0), 0.0)
        prev = lpc.clone()
        lpc[:, i] = r
        for j in range(i):
            lpc[:, j] = prev[:, j] + r * prev[:, i - 1 - j]
        err = err * (1.0 - r * r)
        out[:, i, :i + 1] = -lpc[:, :i + 1]
        errs[:, i] = err
    return out, errs


def _quantize_lpc(coef: torch.Tensor, order: torch.Tensor, precision: int):
    """libFLAC's lpc_quantize_coefficients, batched: coef [n, 8] (zero
    past each row's order) -> (int64 coefficients [n, 8], shift [n])."""
    prec = precision - 1
    qmax, qmin = (1 << prec) - 1, -(1 << prec)
    cmax = coef.abs().max(1).values
    _, e = torch.frexp(torch.where(cmax > 0, cmax, 1.0))
    # cmax < 2**e, so cmax * 2**(prec - e) < 2**prec.
    shift = torch.clamp(prec - e.long(), 0, 15)
    scale = torch.pow(2.0, shift.double())
    q = torch.zeros(coef.shape, dtype=torch.int64, device=coef.device)
    errf = torch.zeros_like(cmax)
    for j in range(coef.shape[1]):
        errf = errf + coef[:, j] * scale
        qj = torch.clamp(torch.round(errf), qmin, qmax)
        qj = torch.where(j < order, qj, 0.0)
        errf = torch.where(j < order, errf - qj, 0.0)
        q[:, j] = qj.long()
    return q, shift


def _predict(x: torch.Tensor, coeffs: torch.Tensor, shift: torch.Tensor,
             order: torch.Tensor) -> torch.Tensor:
    """Exact residuals x[i] - (sum_j c_j x[i-1-j] >> shift) for i >=
    order, 0 before; int64."""
    n, B = x.shape
    pad = torch.nn.functional.pad(x, (MAX_ORDER, 0))
    pred = torch.zeros_like(x)
    for j in range(coeffs.shape[1]):
        pred += coeffs[:, j:j + 1] * pad[:, MAX_ORDER - 1 - j:
                                         MAX_ORDER - 1 - j + B]
    r = x - (pred >> shift[:, None])
    idx = torch.arange(B, device=x.device)[None, :]
    return torch.where(idx >= order[:, None], r, 0)


def _analyse(x: torch.Tensor, bps: torch.Tensor, enc: dict):
    """Choose every subframe's coding. x [n, B] int64 samples, bps [n]
    their widths. Returns a dict of per-row tensors: kind, order, shift,
    coeffs [n, 8], resid [n, B], method, po, params, bits (the whole
    subframe's), rice_bits (its residual section's)."""
    n, B = x.shape
    dev = x.device
    max_order = enc["max_lpc_order"]
    precision = enc["qlp_precision"]
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    const = (x == x[:, :1]).all(1)
    verb_bits = 8 + B * bps

    # Fixed: the order of least summed |residual|, from sample 4 on.
    fixed_cf = torch.zeros((5, MAX_ORDER), dtype=torch.int64, device=dev)
    for k, cf in enumerate(FIXED):
        fixed_cf[k, :k] = torch.tensor(cf, dtype=torch.int64)
    d, sabs = x, []
    for k in range(5):
        sabs.append(d[:, max(4, k):].abs().sum(1) if B > 4 else
                    d.abs().sum(1))
        d = torch.diff(d, dim=1, prepend=torch.zeros_like(d[:, :1]))
    f_order = torch.stack(sabs, 1).argmin(1)
    f_order = torch.minimum(f_order, torch.full_like(f_order, B - 1))
    f_cf = fixed_cf[f_order]
    f_res = _predict(x, f_cf, zeros, f_order)
    f_rice = _rice_plan(f_res, f_order, enc["max_partition_order"])
    f_bits = 8 + f_order * bps + f_rice[0]

    # LPC: windowed autocorrelation, Levinson, the order by libFLAC's
    # estimate, quantised coefficients, exact residuals.
    xw = x.double() * _tukey(B, enc["tukey_p"], dev)[None, :]
    autoc = torch.stack([(xw[:, :B - lag] * xw[:, lag:]).sum(1)
                         for lag in range(max_order + 1)], 1)
    lp, errs = _levinson(autoc, max_order)
    orders = torch.arange(1, max_order + 1, device=dev)[None, :]
    scale = 0.5 / B
    ebps = torch.where(errs > 0, 0.5 * torch.log2(
        torch.where(errs > 0, errs, 1.0) * scale), 0.0).clamp_min(0.0)
    est = ebps * (B - orders) + orders * (bps[:, None] + precision)
    l_order = est.argmin(1) + 1
    l_order = torch.minimum(l_order, torch.full_like(l_order, max(B - 1, 1)))
    coef = torch.gather(lp, 1, (l_order - 1)[:, None, None].expand(
        n, 1, max_order))[:, 0]
    coef = torch.nn.functional.pad(coef, (0, MAX_ORDER - max_order))
    l_cf, l_shift = _quantize_lpc(coef, l_order, precision)
    l_ok = (autoc[:, 0] > 0) & (l_cf != 0).any(1) & (l_order < B)
    l_res = _predict(x, l_cf, l_shift, l_order)
    # A residual must fit in 32 signed bits (RFC 9639 9.2.7.1).
    l_ok &= (l_res.abs() < (1 << 30)).all(1)
    l_rice = _rice_plan(l_res, l_order, enc["max_partition_order"])
    l_bits = 8 + l_order * bps + 4 + 5 + l_order * precision + l_rice[0]
    big = torch.iinfo(torch.int64).max // 2
    l_bits = torch.where(l_ok, l_bits, big)

    use_lpc = l_bits < torch.minimum(f_bits, verb_bits)
    use_fix = (~use_lpc) & (f_bits < verb_bits)
    kind = torch.where(const, KIND_CONST, torch.where(
        use_lpc, KIND_LPC, torch.where(use_fix, KIND_FIXED, KIND_VERBATIM)))
    coded = (kind == KIND_FIXED) | (kind == KIND_LPC)
    lpc = kind == KIND_LPC
    pick = lambda a, b: torch.where(lpc.view(-1, *([1] * (a.dim() - 1))),
                                    a, b)
    out = dict(
        kind=kind,
        order=torch.where(coded, pick(l_order, f_order), 0),
        shift=torch.where(lpc, l_shift, 0),
        coeffs=torch.where(coded[:, None], pick(l_cf, f_cf), 0),
        resid=torch.where(coded[:, None], pick(l_res, f_res), x),
        method=pick(l_rice[1], f_rice[1]),
        po=pick(l_rice[2], f_rice[2]),
        params=pick(l_rice[3], f_rice[3]),
        rice_bits=torch.where(coded, pick(l_rice[0], f_rice[0]), 0),
    )
    out["bits"] = torch.where(const, 8 + bps, torch.where(
        lpc, l_bits, torch.where(use_fix, f_bits, verb_bits)))
    out["x"] = x
    out["bps"] = bps
    out["precision"] = precision
    return out


def _slots(a: dict):
    """(widths, values) [n, 20 + 2B] of every subframe's fields in
    stream order: header, warm-ups (or the constant), LPC precision,
    shift and coefficients, Rice method and partition order, then per
    sample its partition's parameter (at a partition start) and its
    code (a Rice code, or the verbatim sample)."""
    x, kind, order, bps = a["x"], a["kind"], a["order"], a["bps"]
    n, B = x.shape
    x8 = torch.nn.functional.pad(x, (0, max(0, MAX_ORDER - B)))[:, :MAX_ORDER]
    dev = x.device
    W = torch.zeros((n, 20 + 2 * B), dtype=torch.int64, device=dev)
    V = torch.zeros_like(W)
    lpc = kind == KIND_LPC
    coded = lpc | (kind == KIND_FIXED)
    typ = torch.where(kind == KIND_CONST, 0, torch.where(
        kind == KIND_VERBATIM, 1, torch.where(
            kind == KIND_FIXED, 8 + order, 31 + order)))
    W[:, 0] = 8
    V[:, 0] = typ << 1
    mask_b = (1 << bps[:, None]) - 1
    j = torch.arange(MAX_ORDER, device=dev)[None, :]
    warm_on = (j < order[:, None]) | ((j == 0) & (kind == KIND_CONST)[:, None])
    W[:, 1:9] = torch.where(warm_on, bps[:, None], 0)
    V[:, 1:9] = torch.where(warm_on, x8 & mask_b, 0)
    prec = a["precision"]
    W[:, 9] = torch.where(lpc, 4, 0)
    V[:, 9] = prec - 1
    W[:, 10] = torch.where(lpc, 5, 0)
    V[:, 10] = a["shift"]
    cf_on = lpc[:, None] & (j < order[:, None])
    W[:, 11:19] = torch.where(cf_on, prec, 0)
    V[:, 11:19] = torch.where(cf_on, a["coeffs"] & ((1 << prec) - 1), 0)
    W[:, 19] = torch.where(coded, 6, 0)
    V[:, 19] = (a["method"] << 4) | a["po"]
    i = torch.arange(B, device=dev)[None, :]
    plen = B >> a["po"][:, None]
    start = (i % plen) == 0
    P = a["params"].shape[1]
    part = i // (B // P)                      # finest partition of sample i
    k = torch.gather(a["params"], 1, part.expand(n, B))
    W[:, 20::2] = torch.where(coded[:, None] & start, 4 + a["method"][:, None],
                              0)
    V[:, 20::2] = k
    zz = _zigzag(a["resid"])
    live = coded[:, None] & (i >= order[:, None])
    W[:, 21::2] = torch.where(live, (zz >> k) + 1 + k, torch.where(
        (kind == KIND_VERBATIM)[:, None], bps[:, None], 0))
    V[:, 21::2] = torch.where(live, (1 << k) | (zz & ((1 << k) - 1)),
                              x & mask_b)
    return W, V


def _utf8(v: torch.Tensor):
    """FLAC's coded number (UTF-8-like) of frame numbers v [F] < 2**21:
    bytes [F, 4] and their count [F]."""
    F = v.shape[0]
    b = torch.zeros((F, 4), dtype=torch.int64, device=v.device)
    n1, n2, n3 = v < 0x80, v < 0x800, v < 0x10000
    b[:, 0] = torch.where(n1, v, torch.where(
        n2, 0xC0 | (v >> 6), torch.where(n3, 0xE0 | (v >> 12),
                                         0xF0 | (v >> 18))))
    cont = lambda s: 0x80 | ((v >> s) & 0x3F)
    b[:, 1] = torch.where(n2, cont(0), torch.where(n3, cont(6), cont(12)))
    b[:, 2] = torch.where(n3, cont(0), cont(6))
    b[:, 3] = cont(0)
    cnt = torch.where(n1, 1, torch.where(n2, 2, torch.where(n3, 3, 4)))
    return b, cnt


def _headers(block: torch.Tensor, chcode: torch.Tensor, fmt: dict):
    """Frame header bytes [F, 12] and lengths [F], CRC-8 included."""
    F = block.shape[0]
    dev = block.device
    sr = fmt["sample_rate"]
    if sr not in SR_CODE:
        raise ValueError(f"sample rate {sr} has no code of its own")
    hb = torch.zeros((F, 12), dtype=torch.int64, device=dev)
    bs_code = torch.zeros((F,), dtype=torch.int64, device=dev)
    for b, c in BS_CODE.items():
        bs_code = torch.where(block == b, c, bs_code)
    # No code of its own: the size less one follows the coded number.
    bs_code = torch.where(bs_code == 0, torch.where(block <= 256, 6, 7),
                          bs_code)
    hb[:, 0] = 0xFF
    hb[:, 1] = 0xF8                                   # fixed blocking
    hb[:, 2] = (bs_code << 4) | SR_CODE[sr]
    hb[:, 3] = (chcode << 4) | (BPS_CODE[fmt["bits_per_sample"]] << 1)
    num, ncnt = _utf8(torch.arange(F, device=dev))
    for q in range(4):
        hb[:, 4 + q] = torch.where(q < ncnt, num[:, q], 0)
    pos = (4 + ncnt)[:, None]
    ext = block - 1
    one, two = bs_code == 6, bs_code == 7
    hb.scatter_(1, pos, torch.where(one, ext, torch.where(
        two, ext >> 8, 0))[:, None])
    hb.scatter_(1, pos + 1, torch.where(two, ext & 0xFF, 0)[:, None])
    hlen = 4 + ncnt + one.long() + 2 * two.long()
    t8 = torch.tensor(CRC8, dtype=torch.int64, device=dev)
    crc = torch.zeros(F, dtype=torch.int64, device=dev)
    for q in range(11):
        crc = torch.where(q < hlen, t8[crc ^ hb[:, q]], crc)
    hb.scatter_(1, hlen[:, None], crc[:, None])
    return hb, hlen + 1


def _choose_stereo(an: dict, F: int):
    """Per frame the cheapest of independent, left-side, side-right and
    mid-side from the analysis of rows [L, R, M, S] x F."""
    bits = an["bits"].view(4, F)
    L, R, M, S = bits
    cand = torch.stack([L + R, L + S, S + R, M + S])
    choice = cand.argmin(0)
    code = torch.tensor([1, CH_LEFT_SIDE, CH_SIDE_RIGHT, CH_MID_SIDE],
                        device=bits.device)[choice]
    first = torch.tensor([0, 0, 3, 2], device=bits.device)[choice]
    second = torch.tensor([1, 3, 1, 3], device=bits.device)[choice]
    f = torch.arange(F, device=bits.device)
    rows = torch.stack([first * F + f, second * F + f], 1).reshape(-1)
    return code, rows


def _batch(pcm: torch.Tensor, fmt: dict, enc: dict):
    """Analyse frames [F, B, C] of one block size: returns the chosen
    subframes' analysis (rows frame-major, channel-minor) and the
    channel codes [F]."""
    F, B, C = pcm.shape
    bps0 = fmt["bits_per_sample"]
    x = pcm.long()
    if C == 2 and enc["stereo"] == "adaptive":
        l, r = x[..., 0], x[..., 1]
        rows = torch.cat([l, r, (l + r) >> 1, l - r])
        bps = torch.tensor([bps0, bps0, bps0, bps0 + 1],
                           device=x.device).repeat_interleave(F)
        an = _analyse(rows, bps, enc)
        code, pick = _choose_stereo(an, F)
        an = {k: (v[pick] if torch.is_tensor(v) and v.dim() > 0 else v)
              for k, v in an.items()}
        return an, code
    rows = x.permute(0, 2, 1).reshape(F * C, B)
    bps = torch.full((F * C,), bps0, dtype=torch.int64, device=x.device)
    code = torch.full((F,), C - 1, dtype=torch.int64, device=x.device)
    return _analyse(rows, bps, enc), code


def _pack(frames: list, C: int, fmt: dict) -> tuple:
    """Write the frames of all batches (in order) into bytes: returns
    (frame bytes as a uint8 tensor, frame byte lengths [F])."""
    dev = frames[0][0]["x"].device
    hbs, hlens, sub_bits, slots = [], [], [], []
    for an, code, block in frames:
        hb, hlen = _headers(block, code, fmt)
        W, V = _slots(an)
        hbs.append(hb)
        hlens.append(hlen)
        sub_bits.append(W.sum(1).view(-1, C))
        slots.append((W, V))
    hlen = torch.cat(hlens)
    hb = torch.cat(hbs)
    sbits = torch.cat(sub_bits)                        # [F, C]
    body = hlen * 8 + sbits.sum(1)
    flen = (body + 7) // 8 + 2
    fstart = torch.cumsum(flen, 0) - flen
    total = int(flen.sum())
    words = torch.zeros(total // 4 + 2, dtype=torch.int64, device=dev)

    def put(off, w, v):
        on = w > 0
        off, w, v = off[on], w[on], v[on]
        end = off + w - 1
        s = 31 - (end % 32)
        sh = v << s
        wi = end // 32
        words.index_add_(0, wi, sh & 0xFFFFFFFF)
        hi = sh >> 32
        words.index_add_(0, (wi - 1).clamp(min=0), hi)

    col = torch.arange(hb.shape[1], device=dev)[None, :]
    put((fstart[:, None] * 8 + col * 8).reshape(-1),
        torch.where(col < hlen[:, None], 8, 0).reshape(-1), hb.reshape(-1))
    sub_start = (fstart * 8 + hlen * 8)[:, None] + torch.cumsum(sbits, 1) - sbits
    sub_start = sub_start.reshape(-1)
    at = 0
    for W, V in slots:
        n = W.shape[0]
        off = sub_start[at:at + n, None] + torch.cumsum(W, 1) - W
        put(off.reshape(-1), W.reshape(-1), V.reshape(-1))
        at += n
    by = torch.stack([(words >> 24) & 255, (words >> 16) & 255,
                      (words >> 8) & 255, words & 255], 1).reshape(-1)
    return by[:total].clone(), flen


def _crc16_fill(by: torch.Tensor, fstart: torch.Tensor, flen: torch.Tensor):
    """Write each frame's CRC-16 (over all but its last two bytes) into
    those two bytes, all frames together, eight bytes a step. by: int64
    bytes, fstart / flen: the frames' starts and lengths in it."""
    dev = by.device
    t8, A = _crc16_tables(dev)
    last = by.numel() - 1
    n = flen - 2
    crc = torch.zeros(fstart.shape, dtype=torch.int64, device=dev)
    lane = torch.arange(8, device=dev)[None, :]
    for q in range(int(n.max()) // 8):
        b = by[(fstart[:, None] + 8 * q + lane).clamp(max=last)]
        w = (b[:, 0::2] << 8) | b[:, 1::2]
        new = A[3][crc ^ w[:, 0]] ^ A[2][w[:, 1]] ^ A[1][w[:, 2]] ^ A[0][w[:, 3]]
        crc = torch.where(8 * q + 8 <= n, new, crc)
    full = (n // 8) * 8
    for t in range(3):
        p = (fstart + full + 2 * t).clamp(max=last - 1)
        new = A[0][crc ^ ((by[p] << 8) | by[p + 1])]
        crc = torch.where(full + 2 * t + 2 <= n, new, crc)
    tail = by[(fstart + n - 1).clamp(min=0)]
    crc = torch.where(n % 2 == 1,
                      t8[((crc >> 8) ^ tail) & 255] ^ ((crc << 8) & 0xFFFF), crc)
    end = fstart + flen
    by[end - 2] = crc >> 8
    by[end - 1] = crc & 255


def _metadata(fmt: dict, meta: dict, n: int, block: int, flen: np.ndarray,
              md5: bytes) -> bytes:
    """fLaC, STREAMINFO, and as the configuration asks a SEEKTABLE (a
    point every `seektable_every_s`), a VORBIS_COMMENT (vendor and tags)
    and PADDING."""
    sr, C, bps = fmt["sample_rate"], fmt["channels"], fmt["bits_per_sample"]
    blocks = []
    every = meta.get("seektable_every_s", 0)
    if every:
        starts = np.concatenate([[0], np.cumsum(flen)[:-1]])
        pts, seen = [], set()
        for t in range(0, n, int(every * sr)):
            f = t // block
            if f not in seen:
                seen.add(f)
                pts.append(struct.pack(">QQH", f * block, int(starts[f]),
                                       min(block, n - f * block)))
        blocks.append((3, b"".join(pts)))
    tags = meta.get("tags")
    if tags is not None:
        body = struct.pack("<I", len(VENDOR)) + VENDOR
        items = [f"{k}={v}".encode() for k, v in tags.items()]
        body += struct.pack("<I", len(items))
        for it in items:
            body += struct.pack("<I", len(it)) + it
        blocks.append((4, body))
    if meta.get("padding"):
        blocks.append((1, bytes(meta["padding"])))
    si = struct.pack(">HH", block, block)
    si += int(flen.min()).to_bytes(3, "big") + int(flen.max()).to_bytes(3, "big")
    packed = (sr << 44) | ((C - 1) << 41) | ((bps - 1) << 36) | n
    si += packed.to_bytes(8, "big") + md5
    out = b"fLaC" + bytes([0 if blocks else 0x80]) + (34).to_bytes(3, "big") + si
    for i, (t, body) in enumerate(blocks):
        last = 0x80 if i == len(blocks) - 1 else 0
        out += bytes([last | t]) + len(body).to_bytes(3, "big") + body
    return out


def _md5(pcm: np.ndarray, bps: int) -> bytes:
    """MD5 of the samples as little-endian integers of ceil(bps/8)
    bytes (RFC 9639 8.2)."""
    nbytes = (bps + 7) // 8
    if nbytes == 3:
        raw = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return hashlib.md5(raw.tobytes()).digest()
    return hashlib.md5(pcm.astype(f"<i{nbytes}").tobytes()).digest()


def encode_pool(pcms: list, fmt: dict, enc: dict, meta: dict) -> list:
    """Encode each PCM [n, C] (int16, on one device) as a FLAC stream;
    the CRC-16 of every frame of every stream runs in one pass. Returns
    a list of (stream bytes, Side)."""
    B = enc["block_size"]
    C = fmt["channels"]
    dev = pcms[0].device
    streams = []
    for pcm in pcms:
        n = pcm.shape[0]
        full = n // B
        frames = []
        for f0, f1, b in ((0, full, B), (full, full + 1, n - full * B)):
            if f1 > f0 and b:
                fr = pcm[f0 * B:f0 * B + (f1 - f0) * b].view(f1 - f0, b, C)
                an, code = _batch(fr, fmt, enc)
                block = torch.full((f1 - f0,), b, dtype=torch.int64,
                                   device=dev)
                frames.append((an, code, block))
        by, flen = _pack(frames, C, fmt)
        streams.append((pcm, frames, by, flen))
    base = torch.cumsum(torch.tensor([0] + [s[2].numel() for s in streams],
                                     device=dev), 0)
    allby = torch.cat([s[2] for s in streams])
    flens = torch.cat([s[3] for s in streams])
    fstart = torch.cat([base[i] + torch.cumsum(s[3], 0) - s[3]
                        for i, s in enumerate(streams)])
    _crc16_fill(allby, fstart, flens)
    allby = allby.to(torch.uint8).cpu().numpy()
    base = base.cpu().numpy()
    out = []
    for i, (pcm, frames, _, flen) in enumerate(streams):
        n = pcm.shape[0]
        flen = flen.cpu().numpy()
        host = pcm.cpu().numpy()
        head = _metadata(fmt, meta, n, B, flen,
                         _md5(host, fmt["bits_per_sample"]))
        data = head + allby[base[i]:base[i + 1]].tobytes()
        out.append((data, _side(frames, fmt, len(head), int(flen.sum()), n)))
    return out


def encode(pcm: torch.Tensor, fmt: dict, enc: dict, meta: dict):
    """One stream: encode_pool of one PCM."""
    return encode_pool([pcm], fmt, enc, meta)[0]


def _side(frames, fmt: dict, meta_bytes: int, frame_bytes: int,
          n: int) -> Side:
    cat = lambda key: torch.cat([a[key] for a, _, _ in frames]).cpu().numpy()
    side = Side(
        block=np.concatenate([b.cpu().numpy() for _, _, b in frames]),
        chcode=np.concatenate([c.cpu().numpy() for _, c, _ in frames]),
        kind=cat("kind"), order=cat("order"), shift=cat("shift"),
        coeffs=cat("coeffs"),
        warm=np.concatenate([torch.nn.functional.pad(
            a["x"], (0, max(0, MAX_ORDER - a["x"].shape[1])))[:, :MAX_ORDER]
            .cpu().numpy() for a, _, _ in frames]),
        resid=[a["resid"].to(torch.int32).cpu().numpy() for a, _, _ in frames])
    side.counts = _counts(frames, side, fmt, meta_bytes, frame_bytes, n)
    return side


def _counts(frames, side: Side, fmt: dict, meta_bytes: int,
            frame_bytes: int, n: int) -> dict:
    """Counts of the stream's content that the roofline files read."""
    kind, order = side.kind, side.order
    B = np.repeat(side.block, fmt["channels"])
    bps = np.concatenate([a["bps"].cpu().numpy() for a, _, _ in frames])
    rice_bits = np.concatenate([a["rice_bits"].cpu().numpy()
                                for a, _, _ in frames])
    lpc = kind == KIND_LPC
    coded = lpc | (kind == KIND_FIXED)
    return dict(
        samples=int(n), channels=int(fmt["channels"]),
        container_bytes=int(fmt["bits_per_sample"] + 7) // 8,
        frames=int(len(side.block)), subframes=int(len(kind)),
        meta_bytes=int(meta_bytes), frame_bytes=int(frame_bytes),
        rice_bits=int(rice_bits[coded].sum()),
        rice_residuals=int((B - order)[coded].sum()),
        lpc_residuals=int((B - order)[lpc].sum()),
        lpc_sample_bits=int((B * bps)[lpc].sum()),
        lpc_macs=int(((B - order) * order)[lpc].sum()),
        sample_bits=int((B * bps).sum()),
        kinds={name: int((kind == k).sum()) for name, k in
               (("constant", KIND_CONST), ("verbatim", KIND_VERBATIM),
                ("fixed", KIND_FIXED), ("lpc", KIND_LPC))},
    )
