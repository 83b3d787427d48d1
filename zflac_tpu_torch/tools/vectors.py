"""The independent bitstreams of the JAX package's conformance suite,
for the port's tests and chip_smoke.py (which runs where there is no
jax): numpy and the port's own modules only.

- The 20 hand-built vectors of tests/test_handvectors.py, each built
  bit by bit from the RFC 9639 text with its expected PCM from plain
  Python integer math that never touches the format tables, encoder or
  bit writer (the encoder and the decoder read the same format.py, so
  a shared misreading of the spec would pass the round-trip corpus).
  The functions below are that file's code, unchanged.
- The three RFC 9639 example streams of tests/test_golden.py: real
  libflac bits, with their expected samples and format facts.
- The six edge-of-envelope streams of tests/test_edge_cases.py and its
  declared-total cut, encoded with the port's encoder and tone_mix at
  the same seeds, sizes and EncoderConfig fields.

`all_vectors()` returns every stream as a Vector (name, FLAC bytes,
expected interleaved PCM in the container dtype, decode kwargs);
`declared_total_cut()` the cut stream and its declared total.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from .. import format as fmt
from ..encoder import EncoderConfig, encode
from ..result import container_dtype
from ..testing import tone_mix


class Vector(NamedTuple):
    name: str
    data: bytes
    expected: np.ndarray   # interleaved, normalized, container dtype
    kwargs: dict           # what the source test passes to decode


# --------------------------------------------------------------------
# Hand-built vectors (tests/test_handvectors.py): independent
# construction helpers, then one function per vector returning
# (name, flac_bytes, expected_interleaved).
# --------------------------------------------------------------------


class BW:
    """MSB-first bit writer."""

    def __init__(self):
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def w(self, value, nbits):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (int(value) & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.w(0, 8 - self.n)

    def data(self):
        assert self.n == 0
        return bytes(self.out)


def crc8(data):
    # x^8 + x^2 + x + 1, init 0, MSB-first (RFC 9639 frame header CRC).
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else crc << 1
    return crc


def crc16(data):
    # x^16 + x^15 + x^2 + 1, init 0, MSB-first (RFC 9639 frame CRC).
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def utf8_number(v):
    """UTF-8-style coded number (frame/sample number), up to the
    36-bit sample-number domain of variable-blocking streams
    (RFC 9639 §9.1.5; reference parse: zflac.zig:203-214). Encodings
    longer than the minimal one are not produced (overlong forms are
    invalid)."""
    if v < 0x80:
        return bytes([v])
    for k in range(2, 8):           # k total bytes, 2..7
        if v < (1 << (6 * (k - 1) + (7 - k))) or k == 7:
            first = ((0xFF << (8 - k)) & 0xFF) | (v >> (6 * (k - 1)))
            rest = [0x80 | ((v >> (6 * i)) & 0x3F)
                    for i in range(k - 2, -1, -1)]
            return bytes([first] + rest)
    raise AssertionError("coded numbers are at most 36 bits")


def streaminfo(block, sr, channels, bps, total, md5, min_block=None):
    out = bytearray(b"fLaC")
    out += bytes([0x80, 0, 0, 34])  # last=1, type=0 (STREAMINFO), len 34
    bw = BW()
    bw.w(block if min_block is None else min_block, 16)  # min block size
    bw.w(block, 16)          # max block size
    bw.w(0, 24)              # min frame size (unknown)
    bw.w(0, 24)              # max frame size (unknown)
    bw.w(sr, 20)
    bw.w(channels - 1, 3)
    bw.w(bps - 1, 5)
    bw.w(total, 36)
    out += bw.data() + md5
    assert len(out) == 4 + 4 + 34
    return bytes(out)


def zz_enc(r):
    return 2 * r if r >= 0 else -2 * r - 1


def w_rice(bw, r, k):
    zz = zz_enc(r)
    q = zz >> k
    bw.w(0, q)       # q zero bits
    bw.w(1, 1)       # terminator
    bw.w(zz, k)


def w_subframe_header(bw, type_code, wasted):
    bw.w(0, 1)
    bw.w(type_code, 6)
    if wasted:
        bw.w(1, 1)
        bw.w(0, wasted - 1)  # unary: wasted-1 zeros ...
        bw.w(1, 1)           # ... then a 1
    else:
        bw.w(0, 1)


def build_frame(frame_no, bs_code, sr_code, ch_code, bps_code,
                subframes, bs_extra=None, sr_extra=None,
                variable=False):
    """subframes: list of callables(bw). bs_extra/sr_extra: (value,
    nbits) written after the coded number (RFC 9639 §9.1). With
    variable=True the blocking-strategy bit is 1 and frame_no is a
    SAMPLE number (36-bit domain)."""
    bw = BW()
    bw.w(0xFFF9 if variable else 0xFFF8, 16)  # sync + strategy bit
    bw.w(bs_code, 4)
    bw.w(sr_code, 4)
    bw.w(ch_code, 4)
    bw.w(bps_code, 3)
    bw.w(0, 1)
    for b in utf8_number(frame_no):
        bw.w(b, 8)
    if bs_extra is not None:
        bw.w(bs_extra[0], bs_extra[1])
    if sr_extra is not None:
        bw.w(sr_extra[0], sr_extra[1])
    bw.w(crc8(bw.data()), 8)
    for sf in subframes:
        sf(bw)
    bw.align()
    bw.w(crc16(bw.data()), 16)
    return bw.data()


def md5_of(samples, bps):
    nbytes = (bps + 7) // 8
    if nbytes == 3:
        raw = np.asarray(samples, dtype="<i4").tobytes()
        raw = b"".join(raw[i:i + 3] for i in range(0, len(raw), 4))
    else:
        raw = np.asarray(samples, dtype=f"<i{nbytes}").tobytes()
    return hashlib.md5(raw).digest()


def fixed_expect(order, warm, residuals):
    """RFC 9639 fixed-predictor reconstruction in plain Python ints."""
    s = list(warm)
    for r in residuals:
        if order == 0:
            pred = 0
        elif order == 1:
            pred = s[-1]
        elif order == 2:
            pred = 2 * s[-1] - s[-2]
        elif order == 3:
            pred = 3 * s[-1] - 3 * s[-2] + s[-3]
        else:
            pred = 4 * s[-1] - 6 * s[-2] + 4 * s[-3] - s[-4]
        s.append(pred + r)
    return s


def lpc_expect(warm, coeffs, shift, residuals):
    """RFC 9639 LPC reconstruction in plain Python ints (exact
    arbitrary-precision dot + arithmetic shift)."""
    s = list(warm)
    for r in residuals:
        pred = sum(c * s[-1 - j] for j, c in enumerate(coeffs)) >> shift
        s.append(pred + r)
    return s


# --------------------------------------------------------------------
# Vectors: each function returns (name, flac_bytes, expected_interleaved)
# where expected is the decoder's contract output (normalized to the
# container width).
# --------------------------------------------------------------------

CONTAINER = {8: np.int8, 12: np.int16, 16: np.int16,
             20: np.int32, 24: np.int32, 32: np.int32}
NORM_SHIFT = {8: 0, 12: 4, 16: 0, 20: 12, 24: 8, 32: 0}


def finish(name, frames_bytes, block, sr20, channels, bps, pre_norm,
           min_block=None):
    pre = np.asarray(pre_norm)
    md5 = md5_of(pre, bps)
    data = streaminfo(block, sr20, channels, bps, len(pre) // channels,
                      md5, min_block=min_block) + b"".join(frames_bytes)
    dtype = CONTAINER[bps]
    expected = (pre.astype(np.int64) << NORM_SHIFT[bps]).astype(dtype)
    return name, data, expected


def v_po0_fixed1():
    # 1ch 16-bit, block 8, fixed order 1, partition order 0, k=2.
    res = [1, -1, 2, -2, 0, 5, -5]

    def sf(bw):
        w_subframe_header(bw, 8 + 1, 0)
        bw.w(100, 16)          # warm-up
        bw.w(0, 2)             # coding method 0 (Rice 4-bit)
        bw.w(0, 4)             # partition order 0
        bw.w(2, 4)             # k = 2
        for r in res:
            w_rice(bw, r, 2)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(7, 8))
    expect = fixed_expect(1, [100], res)
    return finish("po0 fixed1", [frame], 8, 44100, 1, 16, expect)


def v_escape_mixed():
    # 1ch 16-bit, block 8, fixed order 0, po=1: Rice partition then a
    # non-zero-depth escape partition.
    res_a = [0, -1, 1, -3]
    res_b = [-16, 15, -1, 7]

    def sf(bw):
        w_subframe_header(bw, 8, 0)
        bw.w(0, 2)
        bw.w(1, 4)             # po = 1 -> two partitions of 4
        bw.w(0, 4)             # k = 0
        for r in res_a:
            w_rice(bw, r, 0)
        bw.w(0xF, 4)           # escape
        bw.w(5, 5)             # raw depth 5
        for r in res_b:
            bw.w(r, 5)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(7, 8))
    return finish("escape mixed", [frame], 8, 44100, 1, 16,
                  res_a + res_b)


def v_escape_zero():
    # Escape with depth 0: no residual bits at all, all zeros.
    def sf(bw):
        w_subframe_header(bw, 8, 0)
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(0xF, 4)
        bw.w(0, 5)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(7, 8))
    return finish("escape zero", [frame], 8, 44100, 1, 16, [0] * 8)


def v_rice2_k16():
    # Coding method 1 (Rice2, 5-bit parameters) with k=16 — a parameter
    # unreachable in method-0 streams.
    res = [1, -1, 30000, -30000]

    def sf(bw):
        w_subframe_header(bw, 8, 0)
        bw.w(1, 2)             # coding method 1
        bw.w(0, 4)
        bw.w(16, 5)            # k = 16
        for r in res:
            w_rice(bw, r, 16)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(3, 8))
    return finish("rice2 k16", [frame], 4, 44100, 1, 16, res)


def v_wasted_side():
    # Left-side stereo: constant left with 2 wasted bits, fixed side
    # with 1 wasted bit. R = L - S (side has sub_bps 17).
    side_res = [1, -1, 2]

    def sf_left(bw):
        w_subframe_header(bw, 0, 2)
        bw.w(1000, 14)         # constant at sub_bps - wasted

    def sf_side(bw):
        w_subframe_header(bw, 8 + 1, 1)
        bw.w(200, 16)          # warm-up at 17 - 1 wasted
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(0, 4)
        for r in side_res:
            w_rice(bw, r, 0)

    frame = build_frame(0, 6, 9, 8, 4, [sf_left, sf_side],
                        bs_extra=(3, 8))
    left = [1000 << 2] * 4
    side = [v << 1 for v in fixed_expect(1, [200], side_res)]
    inter = []
    for l, s in zip(left, side):
        inter += [l, l - s]
    return finish("wasted side", [frame], 4, 44100, 2, 16, inter)


def v_midside_extreme():
    # Mid-side at full-scale 16-bit magnitudes: the (mid<<1)|(side&1)
    # rounding must be exact at the extremes.
    LR = [(32767, -32768), (-32768, 32767), (32767, 32767),
          (-32768, -32768)]
    M = [(l + r) >> 1 for l, r in LR]
    S = [l - r for l, r in LR]

    def sf_mid(bw):
        w_subframe_header(bw, 1, 0)    # verbatim
        for m in M:
            bw.w(m, 16)

    def sf_side(bw):
        w_subframe_header(bw, 1, 0)    # verbatim, sub_bps 17
        for s in S:
            bw.w(s, 17)

    frame = build_frame(0, 6, 9, 10, 4, [sf_mid, sf_side],
                        bs_extra=(3, 8))
    inter = []
    for l, r in LR:
        inter += [l, r]
    return finish("midside extreme", [frame], 4, 44100, 2, 16, inter)


def v_po15():
    # Block 32768 (code 15), fixed order 0, partition order 15: 32768
    # partitions of one residual each, parameter varying 0..14.
    def sf(bw):
        w_subframe_header(bw, 8, 0)
        bw.w(0, 2)
        bw.w(15, 4)
        for p in range(32768):
            k = p % 15
            bw.w(k, 4)
            r = [0, -1, 1][p % 3]
            w_rice(bw, r, k)

    frame = build_frame(0, 15, 9, 0, 4, [sf])
    expect = [[0, -1, 1][p % 3] for p in range(32768)]
    return finish("po15", [frame], 32768, 44100, 1, 16, expect)


def v_lpc_edges():
    # 2ch independent. ch0: order-2 LPC, shift 0 (boundary). ch1:
    # order-1 LPC with 15-bit coefficient at the positive edge and
    # shift 14 — floor-division rounding on every step.
    res0 = [1, -2, 0, 1, 0, -1]
    res1 = [1, 0, -1, 2, 0, 0, -3]

    def sf0(bw):
        w_subframe_header(bw, 32 + 1, 0)   # LPC order 2
        bw.w(100, 16)
        bw.w(102, 16)
        bw.w(14, 4)            # precision 15
        bw.w(0, 5)             # shift 0
        bw.w(2, 15)            # c1 (applies to s[t-1])
        bw.w(-1, 15)           # c2
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(1, 4)
        for r in res0:
            w_rice(bw, r, 1)

    def sf1(bw):
        w_subframe_header(bw, 32 + 0, 0)   # LPC order 1
        bw.w(20000, 16)
        bw.w(14, 4)
        bw.w(14, 5)            # shift 14
        bw.w(16383, 15)        # c1 = 2^14 - 1
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(2, 4)
        for r in res1:
            w_rice(bw, r, 2)

    frame = build_frame(0, 6, 9, 1, 4, [sf0, sf1], bs_extra=(7, 8))
    s0 = lpc_expect([100, 102], [2, -1], 0, res0)
    s1 = lpc_expect([20000], [16383], 14, res1)
    inter = []
    for a, b in zip(s0, s1):
        inter += [a, b]
    return finish("lpc edges", [frame], 8, 44100, 2, 16, inter)


def v_32bit_side():
    # 32-bit stream, side-right decorrelation: the side channel is 33
    # bits wide. L = S + R.
    LR = [(2147483647, -2147483648), (-2147483648, 2147483647),
          (0, 0), (5, 3)]
    S = [l - r for l, r in LR]
    R = [r for _, r in LR]

    def sf_side(bw):
        w_subframe_header(bw, 1, 0)
        for s in S:
            bw.w(s, 33)

    def sf_right(bw):
        w_subframe_header(bw, 1, 0)
        for r in R:
            bw.w(r, 32)

    frame = build_frame(0, 6, 9, 9, 7, [sf_side, sf_right],
                        bs_extra=(3, 8))
    inter = []
    for l, r in LR:
        inter += [l, r]
    return finish("32bit side", [frame], 4, 44100, 2, 32, inter)


def v_coded_multibyte():
    # 130 fixed-blocking frames: frame numbers 0..129 cross the one-byte
    # coded-number boundary (128 -> 0xC2 0x80). Uncommon sample rate
    # code 14 (16-bit Hz*10). 8-bit stream.
    frames = []
    expect = []
    for i in range(130):
        v = (i % 120) - 60

        def sf(bw, v=v):
            w_subframe_header(bw, 0, 0)
            bw.w(v, 8)

        frames.append(build_frame(i, 6, 14, 0, 1, [sf],
                                  bs_extra=(15, 8), sr_extra=(4410, 16)))
        expect += [v] * 16
    return finish("coded multibyte", frames, 16, 44100, 1, 8, expect)


def v_bps12():
    # 12-bit stream: container int16, normalization shift 4.
    vals = [2047, -2048, 1, -1]

    def sf(bw):
        w_subframe_header(bw, 1, 0)
        for v in vals:
            bw.w(v, 12)

    frame = build_frame(0, 6, 9, 0, 2, [sf], bs_extra=(3, 8))
    return finish("bps12", [frame], 4, 44100, 1, 12, vals)


def v_bs192_fixed4_20bit():
    # Block-size code 1 (192 samples), fixed order 4 on a quadratic
    # (residuals exactly zero), 20-bit stream (3-byte MD5 domain,
    # normalization shift 12).
    warm = [0, 1, 4, 9]

    def sf(bw):
        w_subframe_header(bw, 8 + 4, 0)
        for w in warm:
            bw.w(w, 20)
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(0, 4)
        for _ in range(192 - 4):
            w_rice(bw, 0, 0)

    frame = build_frame(0, 1, 9, 0, 5, [sf])
    expect = [t * t for t in range(192)]
    assert expect == fixed_expect(4, warm, [0] * 188)
    return finish("bs192 fixed4 20bit", [frame], 192, 44100, 1, 20,
                  expect)


def v_varblock_36bit():
    # Variable blocking strategy: the coded number is a SAMPLE number
    # in the 36-bit domain (zflac.zig:203-214 parses up to 7 coded
    # bytes). Three frames of different block sizes whose sample
    # numbers exercise the 6-byte and 7-byte encodings — decoders must
    # parse (and may ignore) them, like the reference. Frame sizes 16,
    # 8, 4 (bs codes 6 with stored-1 values).
    sizes = [16, 8, 4]
    # Sample numbers: a 7-byte (>= 2^31) and 6-byte encodings. The
    # reference never validates continuity, and neither do we.
    numbers = [(1 << 35) | 12345, (1 << 35) | 12345 + 16, (1 << 30) + 7]
    assert len(utf8_number(numbers[0])) == 7
    assert len(utf8_number(numbers[2])) == 6
    frames = []
    expect = []
    base = 0
    for bs, num in zip(sizes, numbers):
        vals = [((base + t) * 37 % 4001) - 2000 for t in range(bs)]
        base += bs

        def sf(bw, vals=vals):
            w_subframe_header(bw, 1, 0)    # verbatim
            for v in vals:
                bw.w(v, 16)

        frames.append(build_frame(num, 6, 9, 0, 4, [sf],
                                  bs_extra=(bs - 1, 8), variable=True))
        expect += vals
    return finish("varblock 36bit", frames, 16, 44100, 1, 16, expect,
                  min_block=4)


def v_sr_uncommon_codes():
    # Uncommon sample-rate headers: code 12 (8-bit kHz), code 13
    # (16-bit Hz), code 14 (16-bit Hz*10) — zflac.zig:367-374. Three
    # frames, all resolving to the STREAMINFO rate 32000 Hz three
    # different ways: 32 kHz (code 12), 32000 Hz (code 13), 3200x10
    # (code 14). An engine that mis-parses the extra field desyncs the
    # bitstream and fails loudly. (The reference stores the code-12
    # byte as raw kHz without the x1000 — zflac.zig:369 — which would
    # flag this stream InconsistentParameters; this repo resolves the
    # RFC 9639 semantics, a documented divergence.)
    vals_per_frame = [[100 * i + t for t in range(8)] for i in range(3)]
    headers = [(12, (32, 8)), (13, (32000, 16)), (14, (3200, 16))]
    frames = []
    expect = []
    for i, ((code, extra), vals) in enumerate(zip(headers,
                                                  vals_per_frame)):
        def sf(bw, vals=vals):
            w_subframe_header(bw, 1, 0)
            for v in vals:
                bw.w(v, 16)

        frames.append(build_frame(i, 6, code, 0, 4, [sf],
                                  bs_extra=(7, 8), sr_extra=extra))
        expect += vals
    return finish("sr uncommon codes", frames, 8, 32000, 1, 16, expect)


def v_lpc_order32():
    # Hand-computed LPC at the maximum order 32 (type code 63,
    # zflac.zig:499-541): 12-bit precision coefficients, shift 10,
    # warm-ups spanning the full 16-bit range. The order-32 dot product
    # is the reference's SIMD kernel path (linear_predictor,
    # zflac.zig:604-612).
    warm = [((t * 131) % 3001) - 1500 for t in range(32)]
    coeffs = [((7 * j + 3) % 129) - 64 for j in range(32)]  # c1..c32
    res = [1, -2, 3, -5, 8, -13, 21, -34, 0, 2, -2, 4, -4, 6, -6, 7,
           -7, 9, -9, 11, -11, 13, -13, 15, -15, 17, -17, 19, -19, 0,
           1, -1]

    def sf(bw):
        w_subframe_header(bw, 32 + 31, 0)  # LPC order 32
        for w in warm:
            bw.w(w, 16)
        bw.w(11, 4)            # precision 12
        bw.w(10, 5)            # shift 10
        for c in coeffs:
            bw.w(c, 12)
        bw.w(0, 2)
        bw.w(0, 4)             # po 0
        bw.w(3, 4)             # k = 3
        for r in res:
            w_rice(bw, r, 3)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(63, 8))
    expect = lpc_expect(warm, coeffs, 10, res)
    assert len(expect) == 64
    return finish("lpc order32", [frame], 64, 44100, 1, 16, expect)


def v_bs65535_24bit():
    # Block size 65535 via the uncommon 16-bit code 7 (stored value
    # minus one; 0xFFFF itself is forbidden — zflac.zig:356-365), on a
    # 24-bit stream: pins the bs_code-7 decode AND the 3-low-bytes MD5
    # domain of 24-bit samples (zflac.zig:268-274) at the format's
    # maximum block size. Constant subframe keeps the stream tiny.
    def sf(bw):
        w_subframe_header(bw, 0, 0)
        bw.w(-4660 * 256 - 18, 24)     # 0xFFB79CEE-ish 24-bit value

    frame = build_frame(0, 7, 9, 0, 6, [sf], bs_extra=(65534, 16))
    val = -4660 * 256 - 18
    return finish("bs65535 24bit", [frame], 65535, 44100, 1, 24,
                  [val] * 65535)


def v_8ch_fixed():
    # 8 independent channels (ch_code 7) in one frame: per-channel
    # fixed order-1 predictors with distinct warm-ups and residuals —
    # pins the channel-count decode and 8-way interleave order.
    per_ch_res = [[c, -c, 2 * c + 1] for c in range(8)]

    def make_sf(ch):
        def sf(bw, ch=ch):
            w_subframe_header(bw, 8 + 1, 0)
            bw.w(1000 * ch - 3500, 16)   # warm-up
            bw.w(0, 2)
            bw.w(0, 4)
            bw.w(3, 4)                   # k = 3
            for r in per_ch_res[ch]:
                w_rice(bw, r, 3)
        return sf

    frame = build_frame(0, 6, 9, 7, 4, [make_sf(c) for c in range(8)],
                        bs_extra=(3, 8))
    chans = [fixed_expect(1, [1000 * c - 3500], per_ch_res[c])
             for c in range(8)]
    inter = []
    for t in range(4):
        inter += [chans[c][t] for c in range(8)]
    return finish("8ch fixed", [frame], 4, 44100, 8, 16, inter)


def v_rice2_k28():
    # Rice2 (method 1) with k = 28 — deep 5-bit-parameter territory:
    # residual magnitudes up to 2^28 keep the zigzag under 2^31 while
    # the remainder spans 28 bits (q is tiny). Pins the wide-remainder
    # extraction on a 32-bit mono stream (no decorrelation).
    res = [1 << 28, -(1 << 28), 1, 0, -(3 << 26), 5, -5, (1 << 27) + 9]

    def sf(bw):
        w_subframe_header(bw, 8, 0)      # fixed order 0
        bw.w(1, 2)                       # coding method 1 (Rice2)
        bw.w(0, 4)                       # po 0
        bw.w(28, 5)                      # k = 28
        for r in res:
            w_rice(bw, r, 28)

    frame = build_frame(0, 6, 9, 0, 7, [sf], bs_extra=(7, 8))
    return finish("rice2 k28", [frame], 8, 44100, 1, 32, res)


def v_block1_final():
    # A final frame of block size 1 is legal (zflac.zig:404-405): two
    # frames, block 8 then block 1, via the uncommon 8-bit code 6.
    def sf_a(bw):
        w_subframe_header(bw, 8 + 1, 0)    # fixed order 1
        bw.w(500, 16)
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(1, 4)
        for r in [3, -3, 2, -2, 1, -1, 4]:
            w_rice(bw, r, 1)

    def sf_b(bw):
        w_subframe_header(bw, 0, 0)        # constant
        bw.w(-7, 16)

    f0 = build_frame(0, 6, 9, 0, 4, [sf_a], bs_extra=(7, 8))
    f1 = build_frame(1, 6, 9, 0, 4, [sf_b], bs_extra=(0, 8))
    expect = fixed_expect(1, [500], [3, -3, 2, -2, 1, -1, 4]) + [-7]
    return finish("block1 final", [f0, f1], 8, 44100, 1, 16, expect,
                  min_block=1)


def v_lpc_neg_coeff_edge():
    # LPC order 1 with the most negative precision-15 coefficient
    # (-2^14) and shift 14: the prediction is -s[t-1] with exact
    # floor-division rounding of the negative product every step.
    res = [1, -1, 2, 0, -2, 3, 5]

    def sf(bw):
        w_subframe_header(bw, 32 + 0, 0)
        bw.w(12345, 16)
        bw.w(14, 4)            # precision 15
        bw.w(14, 5)            # shift 14
        bw.w(-16384, 15)       # c1 = -2^14
        bw.w(0, 2)
        bw.w(0, 4)
        bw.w(2, 4)
        for r in res:
            w_rice(bw, r, 2)

    frame = build_frame(0, 6, 9, 0, 4, [sf], bs_extra=(7, 8))
    expect = lpc_expect([12345], [-16384], 14, res)
    return finish("lpc neg edge", [frame], 8, 44100, 1, 16, expect)


VECTORS = [v_po0_fixed1, v_escape_mixed, v_escape_zero, v_rice2_k16,
           v_wasted_side, v_midside_extreme, v_po15, v_lpc_edges,
           v_32bit_side, v_coded_multibyte, v_bps12,
           v_bs192_fixed4_20bit, v_varblock_36bit, v_sr_uncommon_codes,
           v_lpc_order32, v_bs65535_24bit, v_8ch_fixed, v_rice2_k28,
           v_block1_final, v_lpc_neg_coeff_edge]


# --------------------------------------------------------------------
# RFC 9639 appendix example streams (tests/test_golden.py; the
# reference pins the same bytes in tests/basic.zig).
# --------------------------------------------------------------------

# "Example 1": 2ch 16-bit 44.1kHz, one frame of 2 samples.
EXAMPLE_1 = bytes([
    0x66, 0x4c, 0x61, 0x43, 0x80, 0x00, 0x00, 0x22, 0x10, 0x00, 0x10, 0x00,
    0x00, 0x00, 0x0f, 0x00, 0x00, 0x0f, 0x0a, 0xc4, 0x42, 0xf0, 0x00, 0x00,
    0x00, 0x01, 0x3e, 0x84, 0xb4, 0x18, 0x07, 0xdc, 0x69, 0x03, 0x07, 0x58,
    0x6a, 0x3d, 0xad, 0x1a, 0x2e, 0x0f, 0xff, 0xf8, 0x69, 0x18, 0x00, 0x00,
    0xbf, 0x03, 0x58, 0xfd, 0x03, 0x12, 0x8b, 0xaa, 0x9a,
])
EXAMPLE_1_SAMPLES = np.array([25588, 10416], dtype=np.int16)

# "Example 2": 2ch 16-bit, 19 samples, two frames, fixed + LPC +
# constant subframes, vorbis comment + padding metadata.
EXAMPLE_2 = bytes([
    0x66, 0x4c, 0x61, 0x43, 0x00, 0x00, 0x00, 0x22, 0x00, 0x10, 0x00, 0x10,
    0x00, 0x00, 0x17, 0x00, 0x00, 0x44, 0x0a, 0xc4, 0x42, 0xf0, 0x00, 0x00,
    0x00, 0x13, 0xd5, 0xb0, 0x56, 0x49, 0x75, 0xe9, 0x8b, 0x8d, 0x8b, 0x93,
    0x04, 0x22, 0x75, 0x7b, 0x81, 0x03, 0x03, 0x00, 0x00, 0x12, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x10, 0x04, 0x00, 0x00, 0x3a, 0x20, 0x00, 0x00, 0x00,
    0x72, 0x65, 0x66, 0x65, 0x72, 0x65, 0x6e, 0x63, 0x65, 0x20, 0x6c, 0x69,
    0x62, 0x46, 0x4c, 0x41, 0x43, 0x20, 0x31, 0x2e, 0x33, 0x2e, 0x33, 0x20,
    0x32, 0x30, 0x31, 0x39, 0x30, 0x38, 0x30, 0x34, 0x01, 0x00, 0x00, 0x00,
    0x0e, 0x00, 0x00, 0x00, 0x54, 0x49, 0x54, 0x4c, 0x45, 0x3d, 0xd7, 0xa9,
    0xd7, 0x9c, 0xd7, 0x95, 0xd7, 0x9d, 0x81, 0x00, 0x00, 0x06, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0xff, 0xf8, 0x69, 0x98, 0x00, 0x0f, 0x99, 0x12,
    0x08, 0x67, 0x01, 0x62, 0x3d, 0x14, 0x42, 0x99, 0x8f, 0x5d, 0xf7, 0x0d,
    0x6f, 0xe0, 0x0c, 0x17, 0xca, 0xeb, 0x21, 0x00, 0x0e, 0xe7, 0xa7, 0x7a,
    0x24, 0xa1, 0x59, 0x0c, 0x12, 0x17, 0xb6, 0x03, 0x09, 0x7b, 0x78, 0x4f,
    0xaa, 0x9a, 0x33, 0xd2, 0x85, 0xe0, 0x70, 0xad, 0x5b, 0x1b, 0x48, 0x51,
    0xb4, 0x01, 0x0d, 0x99, 0xd2, 0xcd, 0x1a, 0x68, 0xf1, 0xe6, 0xb8, 0x10,
    0xff, 0xf8, 0x69, 0x18, 0x01, 0x02, 0xa4, 0x02, 0xc3, 0x82, 0xc4, 0x0b,
    0xc1, 0x4a, 0x03, 0xee, 0x48, 0xdd, 0x03, 0xb6, 0x7c, 0x13, 0x30,
])
EXAMPLE_2_SAMPLES = np.array([
    10372, 6070, 18041, 10545, 14942, 8743, 17876, 10449, 15627, 9143,
    17899, 10463, 16242, 9502, 18077, 10569, 16824, 9840, 18263, 10680,
    17295, 10113, -14418, -8428, -15201, -8895, -14508, -8476,
    -15195, -8896, -14818, -8653,
    np.int16(0xc382 - 0x10000), np.int16(0b1101110010010000 - 0x10000),
    np.int16(0xc40b - 0x10000), np.int16(0b1101110100000010 - 0x10000),
    np.int16(0xc14a - 0x10000), np.int16(0b1101101100111110 - 0x10000),
], dtype=np.int16)

# "Example 3": 1ch 8-bit 32kHz, fixed-predictor frame of 24 samples.
EXAMPLE_3 = bytes([
    0x66, 0x4c, 0x61, 0x43, 0x80, 0x00, 0x00, 0x22, 0x10, 0x00, 0x10, 0x00,
    0x00, 0x00, 0x1f, 0x00, 0x00, 0x1f, 0x07, 0xd0, 0x00, 0x70, 0x00, 0x00,
    0x00, 0x18, 0xf8, 0xf9, 0xe3, 0x96, 0xf5, 0xcb, 0xcf, 0xc6, 0xdc, 0x80,
    0x7f, 0x99, 0x77, 0x90, 0x6b, 0x32, 0xff, 0xf8, 0x68, 0x02, 0x00, 0x17,
    0xe9, 0x44, 0x00, 0x4f, 0x6f, 0x31, 0x3d, 0x10, 0x47, 0xd2, 0x27, 0xcb,
    0x6d, 0x09, 0x08, 0x31, 0x45, 0x2b, 0xdc, 0x28, 0x22, 0x22, 0x80, 0x57,
    0xa3,
])
EXAMPLE_3_SAMPLES = np.array(
    [0, 79, 111, 78, 8, -61, -90, -68, -13, 42, 67, 53, 13, -27, -46, -38,
     -12, 14, 24, 19, 6, -4, -5, 0], dtype=np.int8)


class ExampleFacts(NamedTuple):
    channels: int
    bits_per_sample: int
    sample_rate: int
    dtype: type


# name -> (bytes, expected samples, the format facts test_golden.py
# asserts of it).
EXAMPLES = {
    "EXAMPLE_1": (EXAMPLE_1, EXAMPLE_1_SAMPLES,
                  ExampleFacts(2, 16, 44100, np.int16)),
    "EXAMPLE_2": (EXAMPLE_2, EXAMPLE_2_SAMPLES,
                  ExampleFacts(2, 16, 44100, np.int16)),
    "EXAMPLE_3": (EXAMPLE_3, EXAMPLE_3_SAMPLES,
                  ExampleFacts(1, 8, 32000, np.int8)),
}


# --------------------------------------------------------------------
# Edge-of-envelope streams (tests/test_edge_cases.py), made with the
# port's encoder.
# --------------------------------------------------------------------


def expected_output(pcm: np.ndarray, bps: int) -> np.ndarray:
    """Decoder output for encoder input `pcm`: natural-width samples
    shifted to the container's MSBs, interleaved."""
    shift = fmt.normalization_shift(bps)
    return (pcm.astype(np.int64) << shift).astype(
        container_dtype(bps)).reshape(-1)


# name -> (PCM maker, sample rate, bits, EncoderConfig fields, decode
# kwargs), each as its test in tests/test_edge_cases.py builds it.
EDGE_CASES = {
    "single_sample_stream": (
        lambda: np.array([[1234, -4321]], dtype=np.int64), 44100, 16,
        dict(block_size=4096), {}),
    "final_block_size_one": (
        lambda: tone_mix(4097, 1, 16, seed=1), 44100, 16,
        dict(block_size=4096), {}),
    "empty_stream": (
        lambda: np.zeros((0, 2), dtype=np.int64), 44100, 16, {}, {}),
    "unknown_total_with_tiny_frames": (
        lambda: tone_mix(100, 2, 16, seed=2), 44100, 16,
        dict(block_size=16, omit_total_samples=True), {}),
    "wrong_total_grows": (
        lambda: tone_mix(3000, 2, 16, seed=3), 44100, 16,
        dict(block_size=512, total_samples_fudge=-1500),
        {"verify_md5": True}),
    "8bit_minimum_depth": (
        lambda: tone_mix(500, 1, 8, seed=4), 8000, 8,
        dict(block_size=256), {}),
}


def edge_case(name: str) -> Vector:
    make, rate, bps, cfg, kwargs = EDGE_CASES[name]
    pcm = make()
    data = encode(pcm, rate, bps, EncoderConfig(**cfg))
    return Vector(name, data, expected_output(pcm, bps), kwargs)


# test_declared_total_cuts_at_frame_boundary: 6 frames of 512 whose
# STREAMINFO declares 1024 samples, so decoding stops 4 whole frames
# early; the stream MD5 covers all 3072, so only a decode that skips
# the MD5 check returns.
CUT_SAMPLES, CUT_BLOCK, CUT_DECLARED = 3072, 512, 1024


def declared_total_cut() -> tuple:
    """(Vector of the cut stream, expected PCM of the declared samples
    with decode kwargs {"verify_md5": False}; the declared total)."""
    pcm = tone_mix(CUT_SAMPLES, 2, 16, seed=9)
    data = encode(pcm, 44100, 16, EncoderConfig(
        block_size=CUT_BLOCK,
        total_samples_fudge=CUT_DECLARED - CUT_SAMPLES))
    return (Vector("declared_total_cut", data,
                   expected_output(pcm[:CUT_DECLARED], 16),
                   {"verify_md5": False}), CUT_DECLARED)


def all_vectors() -> list:
    """The 29 streams: the 20 hand-built vectors, the three RFC
    examples and the six edge cases, in that order."""
    out = []
    for v in VECTORS:
        _, data, expected = v()
        out.append(Vector(v.__name__, data, expected, {}))
    out += [Vector(name, data, samples, {})
            for name, (data, samples, _) in EXAMPLES.items()]
    out += [edge_case(name) for name in EDGE_CASES]
    return out
