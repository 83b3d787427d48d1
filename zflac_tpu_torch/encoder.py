"""FLAC encoder (test-corpus synthesis).

The reference repo relies on the ietf-wg-cellar conformance corpus, which
is a git submodule that is empty in this snapshot (SURVEY.md §4), so this
engine synthesizes its own conformance streams: this encoder writes RFC
9639 streams covering every decode feature (constant / verbatim / fixed
0-4 / LPC 1-32 subframes, Rice & Rice2 partitions incl. escaped and
zero-depth partitions, wasted bits, all four stereo decorrelation modes,
1-8 channels, 8/12/16/20/24/32 bps, common & uncommon block sizes and
sample rates, fixed & variable blocking strategies, correct CRC-8/CRC-16
and stream MD5).

It shares only `format.py` tables with the decoders; all bit packing is
independent (BitWriter vs BitReader), so encoder->decoder round-trip plus
the stream MD5 is a genuine differential check.

The port's copy of zflac_tpu/encoder.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from . import format as fmt
from .bitio import BitWriter
from .crc import crc8, crc16


@dataclass
class EncoderConfig:
    block_size: int = 4096
    #: "auto" | "constant" | "verbatim" | ("fixed", k) | ("lpc", k)
    subframe_mode: object = "auto"
    #: None = auto per 2ch frame; or one of "independent", "left_side",
    #: "side_right", "mid_side" (cycled if a list is given).
    stereo_mode: object = None
    #: None = auto; int forces the Rice partition order (must divide).
    partition_order: int | None = None
    #: 0 = Rice (4-bit params), 1 = Rice2 (5-bit params), None = auto.
    coding_method: int | None = None
    #: Force escaped (raw) partitions.
    force_escape: bool = False
    max_lpc_order: int = 8
    #: Quantized LPC coefficient precision in bits (libflac uses 15).
    lpc_precision: int = 14
    #: Use the variable blocking strategy (sample-number coded numbers).
    variable_blocking: bool = False
    #: Store sample rate / block size / bit depth via uncommon paths.
    uncommon_sample_rate: bool = False
    uncommon_block_size: bool = False
    bps_from_streaminfo: bool = False
    #: Zero the STREAMINFO total-samples field (unknown-length stream).
    omit_total_samples: bool = False
    #: Lie in STREAMINFO total-samples by this delta (buffer-growth tests).
    total_samples_fudge: int = 0
    #: Optional metadata blocks: vorbis comments {KEY: value}, padding
    #: bytes, and a SEEKTABLE point every N samples (0 = none).
    tags: dict | None = None
    padding: int = 0
    seektable_every: int = 0
    seed: int = 0
    stats: dict = field(default_factory=dict)


def _zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else (-(v << 1) - 1)


def _rice_cost(zigzags: list[int], k: int) -> int:
    return sum((z >> k) + 1 + k for z in zigzags)


def _best_rice_param(zigzags: list[int], max_k: int) -> tuple[int, int]:
    """(k, cost) minimizing the exact Rice bit cost."""
    best_k, best_cost = 0, _rice_cost(zigzags, 0)
    for k in range(1, max_k + 1):
        c = _rice_cost(zigzags, k)
        if c < best_cost:
            best_k, best_cost = k, c
    return best_k, best_cost


def _signed_depth(values: list[int]) -> int:
    """Smallest width that holds every value as a signed int."""
    d = 1
    for v in values:
        need = v.bit_length() + 1 if v >= 0 else (-v - 1).bit_length() + 1
        if need > d:
            d = need
    return d


def _write_residuals(bw: BitWriter, residuals: list[int], block_size: int,
                     order: int, cfg: EncoderConfig) -> None:
    """Residual section: 2-bit method, 4-bit partition order, partitions
    (mirror of the decode path at zflac.zig:614-666)."""
    if cfg.partition_order is not None:
        po = cfg.partition_order
        assert block_size % (1 << po) == 0 and (block_size >> po) >= order
    else:
        po = 0
        # Deepest order that divides the block and keeps partition 0
        # non-negative, capped for practicality.
        while (po < 6 and block_size % (1 << (po + 1)) == 0
               and (block_size >> (po + 1)) > order):
            po += 1

    # Partition the residuals and pick params.
    parts: list[list[int]] = []
    idx = 0
    for p in range(1 << po):
        count = (block_size >> po) - (order if p == 0 else 0)
        parts.append(residuals[idx:idx + count])
        idx += count
    assert idx == block_size - order

    method = cfg.coding_method
    plans = []  # per partition: ("rice", k) | ("escape", depth)
    need_rice2 = False
    for part in parts:
        zz = [_zigzag(v) for v in part]
        k, rice_bits = _best_rice_param(zz, 30)
        if k > 14:
            need_rice2 = True
        depth = _signed_depth(part) if part else 0
        all_zero = all(v == 0 for v in part)
        can_escape = depth <= 31  # 5-bit raw-depth field
        if (cfg.force_escape or not part) and can_escape:
            plans.append(("escape", 0 if all_zero else depth))
        elif all_zero and can_escape:
            plans.append(("escape", 0))
        elif can_escape and 5 + len(part) * depth < rice_bits:
            plans.append(("escape", depth))
        else:
            plans.append(("rice", k))
    if method is None:
        method = 1 if need_rice2 else 0
    param_bits = fmt.RICE_PARAM_BITS[method]
    escape_code = fmt.RICE_ESCAPE[method]

    bw.write_bits(method, 2)
    bw.write_bits(po, 4)
    for part, plan in zip(parts, plans):
        if plan[0] == "escape":
            depth = plan[1]
            bw.write_bits(escape_code, param_bits)
            bw.write_bits(depth, 5)
            if depth:
                for v in part:
                    bw.write_signed(v, depth)
        else:
            k = min(plan[1], escape_code - 1)
            bw.write_bits(k, param_bits)
            for v in part:
                zz = _zigzag(v)
                bw.write_unary(zz >> k)
                if k:
                    bw.write_bits(zz & ((1 << k) - 1), k)


def _fixed_residuals(samples: list[int], order: int) -> list[int]:
    """Residuals for fixed predictor of `order`
    (inverse of zflac.zig:481-490)."""
    res = []
    coeffs = fmt.FIXED_COEFFS[order]
    for i in range(order, len(samples)):
        pred = 0
        for j, c in enumerate(coeffs):
            pred += c * samples[i - 1 - j]
        res.append(samples[i] - pred)
    return res


def _lpc_analyze(samples: list[int], order: int,
                 precision: int = 14) -> tuple[list[int], int]:
    """Levinson-Durbin LPC + coefficient quantization. Any quantized
    coefficients give a *valid* stream (residuals are computed exactly
    against the quantized predictor); quality only affects size."""
    x = np.asarray(samples, dtype=np.float64)
    n = len(x)
    if n <= order:
        return [0] * order, 0
    # Autocorrelation.
    ac = np.array([np.dot(x[:n - lag], x[lag:]) for lag in range(order + 1)])
    if ac[0] == 0:
        return [0] * order, 0
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[i:0:-1][:i])
        k = acc / err if err != 0 else 0.0
        a[:i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]]) \
            if i else np.array([k])
        err *= (1 - k * k)
        if err <= 0:
            break
    cmax = np.max(np.abs(a)) if order else 0.0
    if cmax == 0:
        return [0] * order, 0
    # Choose shift so coefficients fit `precision` signed bits.
    shift = precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1)
    shift = max(0, min(31, shift))
    q = np.clip(np.round(a * (1 << shift)),
                -(1 << (precision - 1)), (1 << (precision - 1)) - 1)
    return [int(v) for v in q], shift


def _lpc_residuals(samples: list[int], coeffs: list[int],
                   shift: int) -> list[int]:
    order = len(coeffs)
    res = []
    for i in range(order, len(samples)):
        pred = 0
        for j in range(order):
            pred += coeffs[j] * samples[i - 1 - j]
        res.append(samples[i] - (pred >> shift))
    return res


def _encode_subframe(bw: BitWriter, samples: list[int], sub_bps: int,
                     cfg: EncoderConfig) -> None:
    """One subframe: header + payload (mirror of zflac.zig:425-543)."""
    block_size = len(samples)

    # Wasted bits: shared trailing-zero count (zflac.zig:433,447...).
    wasted = 0
    if any(samples):
        wasted = min((v & -v).bit_length() - 1 for v in samples if v)
        wasted = min(wasted, sub_bps - 1)
    if wasted:
        samples = [v >> wasted for v in samples]
    depth = sub_bps - wasted

    mode = cfg.subframe_mode
    all_equal = all(v == samples[0] for v in samples)
    if mode == "auto":
        if all_equal:
            mode = "constant"
        elif cfg.max_lpc_order > 0 and block_size > 2 * cfg.max_lpc_order:
            # Pick best of fixed 0-2 vs LPC by rough cost.
            mode = ("lpc", cfg.max_lpc_order)
        else:
            mode = ("fixed", min(2, block_size - 1) if block_size > 1 else 0)
    if mode == "constant" and not all_equal:
        mode = "verbatim"
    if isinstance(mode, tuple) and mode[1] >= block_size:
        mode = "verbatim"

    def header(type_bits: int) -> None:
        bw.write_bits(0, 1)
        bw.write_bits(type_bits, 6)
        bw.write_bits(1 if wasted else 0, 1)
        if wasted:
            bw.write_unary(wasted - 1)

    if mode == "constant":
        header(fmt.subframe_type_bits(fmt.SF_CONSTANT, 0))
        bw.write_signed(samples[0], depth)
    elif mode == "verbatim":
        header(fmt.subframe_type_bits(fmt.SF_VERBATIM, 0))
        for v in samples:
            bw.write_signed(v, depth)
    elif mode[0] == "fixed":
        order = mode[1]
        header(fmt.subframe_type_bits(fmt.SF_FIXED, order))
        for v in samples[:order]:
            bw.write_signed(v, depth)
        _write_residuals(bw, _fixed_residuals(samples, order),
                         block_size, order, cfg)
    elif mode[0] == "lpc":
        order = mode[1]
        precision = cfg.lpc_precision
        coeffs, shift = _lpc_analyze(samples, order, precision)
        if all(c == 0 for c in coeffs):
            coeffs[0] = 1 << max(shift, 0)  # degenerate: predict s[i-1]
            if shift == 0:
                coeffs[0] = 1
        header(fmt.subframe_type_bits(fmt.SF_LPC, order))
        for v in samples[:order]:
            bw.write_signed(v, depth)
        bw.write_bits(precision - 1, 4)
        bw.write_bits(shift, 5)
        for c in coeffs:
            bw.write_signed(c, precision)
        _write_residuals(bw, _lpc_residuals(samples, coeffs, shift),
                         block_size, order, cfg)
    else:
        raise ValueError(mode)


_STEREO_CODE = {
    "independent": 0b0001,
    "left_side": fmt.CH_LEFT_SIDE,
    "side_right": fmt.CH_SIDE_RIGHT,
    "mid_side": fmt.CH_MID_SIDE,
}


def encode(pcm: np.ndarray, sample_rate: int, bits_per_sample: int,
           cfg: EncoderConfig | None = None) -> bytes:
    """Encode PCM [num_samples, channels] (natural-width signed values)
    into a FLAC stream."""
    cfg = cfg or EncoderConfig()
    pcm = np.atleast_2d(np.asarray(pcm, dtype=np.int64))
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    num_samples, channels = pcm.shape
    assert 1 <= channels <= 8
    bs = cfg.block_size

    # ---- frames ----
    frames = bytearray()
    frame_sizes = []
    frame_offsets = []   # (first_sample, byte offset within frame section)
    pos = 0
    frame_idx = 0
    while pos < num_samples:
        cur_bs = min(bs, num_samples - pos)
        if cfg.variable_blocking and cur_bs > 16 and frame_idx % 3 == 1:
            cur_bs = max(16, cur_bs // 2)  # exercise variable block sizes
        block = pcm[pos:pos + cur_bs]

        if channels == 2:
            smode = cfg.stereo_mode
            if isinstance(smode, (list, tuple)):
                smode = smode[frame_idx % len(smode)]
            if smode is None:
                smode = ("independent", "left_side", "mid_side",
                         "side_right")[frame_idx % 4]
            ch_code = _STEREO_CODE[smode]
        else:
            ch_code = channels - 1
            smode = "independent"

        frame_offsets.append((pos, len(frames)))
        frame = _encode_frame(block, ch_code, smode, sample_rate,
                              bits_per_sample, cur_bs, frame_idx, pos, cfg)
        frames.extend(frame)
        frame_sizes.append(len(frame))
        pos += cur_bs
        frame_idx += 1

    # ---- STREAMINFO (+ optional metadata blocks) ----
    extra_blocks = []
    if cfg.seektable_every:
        pts = []
        nxt = 0
        for i, (first, off) in enumerate(frame_offsets):
            if first >= nxt:
                ns = frame_sizes[i] and (
                    min(cfg.block_size, num_samples - first))
                pts.append((first, off, ns))
                nxt = first + cfg.seektable_every
        body = bytearray()
        for sample, off, ns in pts:
            body += int(sample).to_bytes(8, "big")
            body += int(off).to_bytes(8, "big")
            body += int(ns).to_bytes(2, "big")
        extra_blocks.append((fmt.META_SEEKTABLE, bytes(body)))
    if cfg.tags is not None:
        vendor = b"zflac-tpu encoder"
        body = bytearray(len(vendor).to_bytes(4, "little") + vendor)
        items = [f"{k}={v}".encode() for k, v in cfg.tags.items()]
        body += len(items).to_bytes(4, "little")
        for it in items:
            body += len(it).to_bytes(4, "little") + it
        extra_blocks.append((fmt.META_VORBIS_COMMENT, bytes(body)))
    if cfg.padding:
        extra_blocks.append((fmt.META_PADDING, b"\x00" * cfg.padding))

    bw = BitWriter()
    bw.write_bytes(fmt.SIGNATURE_BYTES)
    bw.write_bits(0 if extra_blocks else 1, 1)  # last metadata block?
    bw.write_bits(fmt.META_STREAMINFO, 7)
    bw.write_bits(34, 24)          # STREAMINFO length
    min_bs = min(bs, num_samples) if not cfg.variable_blocking else 16
    bw.write_bits(min(min_bs, 65535), 16)
    bw.write_bits(min(bs, 65535), 16)
    bw.write_bits(min(min(frame_sizes) if frame_sizes else 0, (1 << 24) - 1), 24)
    bw.write_bits(min(max(frame_sizes) if frame_sizes else 0, (1 << 24) - 1), 24)
    bw.write_bits(sample_rate, 20)
    bw.write_bits(channels - 1, 3)
    bw.write_bits(bits_per_sample - 1, 5)
    total = 0 if cfg.omit_total_samples else \
        max(0, num_samples + cfg.total_samples_fudge)
    bw.write_bits(total, 36)

    # MD5 over natural-width little-endian sample bytes (zflac.zig:267-277)
    nbytes = fmt.md5_bytes_per_sample(bits_per_sample)
    mask = (1 << (8 * nbytes)) - 1
    md5 = hashlib.md5()
    flat = pcm.reshape(-1)
    md5.update(b"".join(
        int(int(v) & mask).to_bytes(nbytes, "little") for v in flat))
    bw.write_bytes(md5.digest())

    for i, (btype, body) in enumerate(extra_blocks):
        bw.write_bits(1 if i + 1 == len(extra_blocks) else 0, 1)
        bw.write_bits(btype, 7)
        bw.write_bits(len(body), 24)
        bw.write_bytes(body)

    return bw.getvalue() + bytes(frames)


def _encode_frame(block: np.ndarray, ch_code: int, smode: str,
                  sample_rate: int, bps: int, block_size: int,
                  frame_idx: int, first_sample: int,
                  cfg: EncoderConfig) -> bytes:
    channels = block.shape[1]
    bw = BitWriter()

    # Block size code (zflac.zig:148-163).
    bs_extra = None
    if cfg.uncommon_block_size or block_size not in fmt.BLOCK_SIZE_CODE:
        if block_size <= 256:
            bs_code, bs_extra = fmt.BS_UNCOMMON_U8, (block_size - 1, 8)
        else:
            bs_code, bs_extra = fmt.BS_UNCOMMON_U16, (block_size - 1, 16)
    else:
        bs_code = fmt.BLOCK_SIZE_CODE[block_size]

    sr_extra = None
    if cfg.uncommon_sample_rate or sample_rate not in fmt.SAMPLE_RATE_CODE:
        if sample_rate % 1000 == 0 and sample_rate // 1000 < 256:
            sr_code, sr_extra = 0b1100, (sample_rate // 1000, 8)
        elif sample_rate < 65536:
            sr_code, sr_extra = 0b1101, (sample_rate, 16)
        elif sample_rate % 10 == 0 and sample_rate // 10 < 65536:
            sr_code, sr_extra = 0b1110, (sample_rate // 10, 16)
        else:
            sr_code = 0b0000  # fall back to streaminfo
    else:
        sr_code = fmt.SAMPLE_RATE_CODE[sample_rate]

    bd_code = 0 if cfg.bps_from_streaminfo else fmt.BIT_DEPTH_CODE[bps]

    bw.write_bits(fmt.FRAME_SYNC, 15)
    bw.write_bits(1 if cfg.variable_blocking else 0, 1)
    bw.write_bits(bs_code, 4)
    bw.write_bits(sr_code, 4)
    bw.write_bits(ch_code, 4)
    bw.write_bits(bd_code, 3)
    bw.write_bits(0, 1)
    coded = first_sample if cfg.variable_blocking else frame_idx
    bw.write_bytes(fmt.coded_number_bytes(coded))
    if bs_extra:
        bw.write_bits(*bs_extra)
    if sr_extra:
        bw.write_bits(*sr_extra)
    header = bw.getvalue()
    bw.write_bits(crc8(header), 8)

    # Channel transform.
    ch_samples: list[list[int]] = []
    sub_bps: list[int] = []
    L = [int(v) for v in block[:, 0]]
    if smode == "left_side":
        R = [int(v) for v in block[:, 1]]
        ch_samples = [L, [l - r for l, r in zip(L, R)]]
        sub_bps = [bps, bps + 1]
    elif smode == "side_right":
        R = [int(v) for v in block[:, 1]]
        ch_samples = [[l - r for l, r in zip(L, R)], R]
        sub_bps = [bps + 1, bps]
    elif smode == "mid_side":
        R = [int(v) for v in block[:, 1]]
        ch_samples = [[(l + r) >> 1 for l, r in zip(L, R)],
                      [l - r for l, r in zip(L, R)]]
        sub_bps = [bps, bps + 1]
    else:
        ch_samples = [[int(v) for v in block[:, c]]
                      for c in range(channels)]
        sub_bps = [bps] * channels

    for s, d in zip(ch_samples, sub_bps):
        _encode_subframe(bw, s, d, cfg)
    bw.align_to_byte()
    body = bw.getvalue()
    bw.write_bits(crc16(body), 16)
    return bw.getvalue()
