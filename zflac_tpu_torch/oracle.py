"""Bit-exact scalar FLAC oracle decoder (pure Python, test-only).

This is the executable specification of RFC 9639 decode semantics for the
TPU engine: slow, sequential, and obviously correct. The production path
(host indexer + XLA/Pallas kernels) is differential-tested against it; it
itself is validated against the three RFC 9639 appendix streams that the
reference inlines (the reference's tests/basic.zig) and against this
repo's encoder round-trip + MD5.

Structure mirrors the reference's call stack (SURVEY.md §3.1):
decode -> metadata walk -> per-frame loop -> per-channel subframe decode
-> residual decode -> reconstruction -> decorrelation -> MD5 -> normalize
(the reference's src/zflac.zig:217-310, 312-602, 614-666).

Known deliberate divergences from the reference (documented, spec-correct):
  * Uncommon 8-bit sample rate is multiplied by 1000 (kHz -> Hz); the
    reference stores the raw byte (zflac.zig:369).
  * A constant subframe on a decorrelated side channel is read at
    bits_per_sample + 1 like every other side subframe (RFC 9639 §9.2.2);
    the reference reads it at bits_per_sample (zflac.zig:447).
  * Frame header CRC-8 / frame CRC-16 can optionally be *verified*
    (`check_crc=True`); the reference reads but never checks them
    (zflac.zig:407-410, 548-551).

The port's copy of zflac_tpu/oracle.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import format as fmt
from .bitio import BitReader
from .crc import crc8, crc16
from .errors import (
    EndOfStream,
    InconsistentParameters,
    InvalidChecksum,
    InvalidCodedNumber,
    InvalidFrameHeader,
    InvalidMetadataHeader,
    InvalidResidualCodingMethod,
    InvalidSignature,
    InvalidSubframeHeader,
    MissingStreaminfo,
)
from .result import DecodedFLAC, container_dtype


def read_coded_number(br: BitReader) -> int:
    """Extended-UTF-8 frame/sample number (zflac.zig:203-214). Like the
    reference, continuation bytes are masked, not validated."""
    first = br.read_u8()
    # Number of leading one bits.
    byte_count = 8 - ((first ^ 0xFF).bit_length())
    if first == 0xFF or byte_count == 1:
        raise InvalidCodedNumber()
    if byte_count == 0:
        return first
    value = first & (0x7F >> byte_count)
    for _ in range(byte_count - 1):
        value = (value << 6) | (br.read_u8() & 0x3F)
    return value


def parse_streaminfo(br: BitReader) -> fmt.StreamInfo:
    """STREAMINFO body (zflac.zig:228-242)."""
    return fmt.StreamInfo(
        min_block_size=br.read_bits(16),
        max_block_size=br.read_bits(16),
        min_frame_size=br.read_bits(24),
        max_frame_size=br.read_bits(24),
        sample_rate=br.read_bits(20),
        channel_count=br.read_bits(3) + 1,
        bits_per_sample=br.read_bits(5) + 1,
        total_samples=br.read_bits(36),
        md5=br.read_bytes(16),
    )


def parse_metadata(br: BitReader) -> fmt.StreamInfo:
    """Signature + metadata block walk (zflac.zig:218-253). Leaves the
    cursor at the first audio frame."""
    if br.read_u32() != fmt.SIGNATURE:
        raise InvalidSignature()
    stream_info = None
    while True:
        header_byte = br.read_u8()
        last = bool(header_byte & 0x80)
        block_type = header_byte & 0x7F
        length = br.read_u24()
        if block_type == fmt.META_STREAMINFO:
            stream_info = parse_streaminfo(br)
        elif block_type <= fmt.META_MAX_VALID:
            br.skip_bytes(length)
        else:
            raise InvalidMetadataHeader()
        if last:
            break
    if stream_info is None:
        raise MissingStreaminfo()
    return stream_info


def _decode_residuals(br: BitReader, block_size: int, order: int) -> list[int]:
    """Rice/Rice2-coded residuals for one subframe
    (zflac.zig:614-666). Returns block_size - order residual values."""
    coding_method = br.read_bits(2)
    if coding_method >= 2:
        raise InvalidResidualCodingMethod()
    partition_order = br.read_bits(4)
    param_bits = fmt.RICE_PARAM_BITS[coding_method]
    escape = fmt.RICE_ESCAPE[coding_method]

    residuals: list[int] = []
    num_partitions = 1 << partition_order
    for partition in range(num_partitions):
        count = block_size >> partition_order
        if partition == 0:
            if count < order:
                # Partition 0 cannot hold the warm-ups (the reference
                # would underflow here, zflac.zig:626).
                raise InvalidFrameHeader()
            count -= order
        rice_parameter = br.read_bits(param_bits)
        if rice_parameter == escape:
            # Escaped partition: raw fixed-width residuals
            # (zflac.zig:645-654).
            raw_depth = br.read_bits(5)
            if raw_depth == 0:
                residuals.extend([0] * count)
            else:
                for _ in range(count):
                    residuals.append(br.read_signed(raw_depth))
        else:
            for _ in range(count):
                quotient = br.read_unary()
                remainder = br.read_bits(rice_parameter)
                zz = (quotient << rice_parameter) + remainder
                # Zigzag decode (zflac.zig:661).
                residuals.append((zz >> 1) ^ -(zz & 1))
    # Non-divisible block/partition combinations leave a zero tail
    # (the reference leaves those samples uninitialized, zflac.zig:624).
    residuals.extend([0] * (block_size - order - len(residuals)))
    return residuals


def _wrap(v: int, bits: int) -> int:
    """Two's-complement wraparound to `bits` width (Zig release-mode
    integer semantics for the container casts, zflac.zig:494,537)."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def decode(data: bytes, check_crc: bool = False,
           verify_md5: bool = True) -> DecodedFLAC:
    """Decode a whole FLAC stream. Bit-exact mirror of
    zflac.decode + decode_frames (zflac.zig:217-602)."""
    br = BitReader(data)
    stream_info = parse_metadata(br)

    cbits = fmt.container_bits(stream_info.bits_per_sample)
    dtype = container_dtype(stream_info.bits_per_sample)

    valid_total = stream_info.total_samples > 0
    expected_channels = stream_info.channel_count
    total_count = expected_channels * (
        stream_info.total_samples if valid_total else 4096)

    samples: list[int] = [0] * total_count

    first_frame = True
    sample_rate = 0
    channel_count = 0
    bit_depth_code = -1
    bits_per_sample = 0
    frame_count = 0

    offset = 0  # interleaved sample write offset
    while True:
        if valid_total and offset >= total_count:
            break
        frame_start_byte = br.pos // 8
        try:
            header_word = br.read_u32()
        except EndOfStream:
            if valid_total:
                raise
            break  # EOF on a frame boundary is legal (zflac.zig:343-350)

        if (header_word >> 17) != fmt.FRAME_SYNC:
            raise InvalidFrameHeader()
        blocking_strategy = (header_word >> 16) & 1
        block_size_code = (header_word >> 12) & 0xF
        sample_rate_code = (header_word >> 8) & 0xF
        channels_code = (header_word >> 4) & 0xF
        bd_code = (header_word >> 1) & 0x7
        # NOTE: like the reference, the mandatory-zero bit 0 is ignored.

        coded_number = read_coded_number(br)
        del blocking_strategy, coded_number  # parsed, not needed further

        if block_size_code == fmt.BS_RESERVED:
            raise InvalidFrameHeader()
        elif block_size_code == fmt.BS_UNCOMMON_U8:
            block_size = br.read_u8() + 1
        elif block_size_code == fmt.BS_UNCOMMON_U16:
            raw = br.read_u16()
            if raw == 0xFFFF:
                raise InvalidFrameHeader()
            block_size = raw + 1
        else:
            block_size = fmt.block_size_value(block_size_code)

        sr_entry = fmt.SAMPLE_RATE_TABLE[sample_rate_code]
        if sr_entry == fmt.SR_STREAMINFO:
            frame_sample_rate = stream_info.sample_rate
        elif sr_entry == fmt.SR_U8_KHZ:
            frame_sample_rate = br.read_u8() * 1000
        elif sr_entry == fmt.SR_U16_HZ:
            frame_sample_rate = br.read_u16()
        elif sr_entry == fmt.SR_U16_HZ_X10:
            frame_sample_rate = br.read_u16() * 10
        elif sr_entry == fmt.SR_FORBIDDEN:
            raise InvalidFrameHeader()
        else:
            frame_sample_rate = sr_entry

        if first_frame:
            sample_rate = frame_sample_rate
            channel_count = fmt.channel_count(channels_code)
            bit_depth_code = bd_code
            if bd_code == 0:
                bits_per_sample = stream_info.bits_per_sample
            elif fmt.BIT_DEPTH_TABLE[bd_code] is None:
                raise InvalidFrameHeader()
            else:
                bits_per_sample = fmt.BIT_DEPTH_TABLE[bd_code]
            if channel_count != expected_channels:
                raise InconsistentParameters()
            first_frame = False
        else:
            # Stream-consistency rules (zflac.zig:389-392): compare the
            # channel *count* (decorrelation mode may change per frame)
            # and the bit-depth *code*.
            if (sample_rate != frame_sample_rate
                    or channel_count != fmt.channel_count(channels_code)
                    or bit_depth_code != bd_code):
                raise InconsistentParameters()

        expected_end = offset + block_size * channel_count
        if len(samples) < expected_end:
            # Amortized growth; the metadata total was wrong/absent
            # (zflac.zig:394-402).
            new_size = max(2 * len(samples), expected_end)
            samples.extend([0] * (new_size - len(samples)))
            valid_total = False

        # Block size 1 only legal in the last frame (zflac.zig:404-405).
        if block_size == 1 and (valid_total and expected_end < total_count):
            raise InvalidFrameHeader()

        header_crc = br.read_u8()
        if check_crc:
            hdr_bytes = data[frame_start_byte:br.pos // 8 - 1]
            if crc8(hdr_bytes) != header_crc:
                raise InvalidChecksum("frame header CRC-8 mismatch")

        # ---- subframes (zflac.zig:425-544) ----
        side = fmt.side_channel(channels_code)
        for channel in range(channel_count):
            if br.read_bits(1) != 0:
                raise InvalidSubframeHeader()
            type_bits = br.read_bits(6)
            wasted_flag = br.read_bits(1)
            wasted = (br.read_unary() + 1) if wasted_flag else 0

            # Side channels carry one extra bit of depth
            # (zflac.zig:435-441).
            sub_bps = bits_per_sample + (1 if channel == side else 0)

            kind_order = fmt.classify_subframe(type_bits)
            if kind_order is None:
                raise InvalidSubframeHeader()
            kind, order = kind_order
            if kind == fmt.SF_FIXED and order > 4:
                raise InvalidSubframeHeader()

            read_depth = sub_bps - wasted
            if read_depth <= 0:
                raise InvalidSubframeHeader()

            if kind == fmt.SF_CONSTANT:
                v = br.read_signed(read_depth) << wasted
                work = [v] * block_size
            elif kind == fmt.SF_VERBATIM:
                work = [br.read_signed(read_depth) << wasted
                        for _ in range(block_size)]
            elif kind == fmt.SF_FIXED:
                work = [br.read_signed(read_depth)
                        for _ in range(order)]
                work += _decode_residuals(br, block_size, order)
                coeffs = fmt.FIXED_COEFFS[order]
                for i in range(order, block_size):
                    pred = 0
                    for j, c in enumerate(coeffs):
                        pred += c * work[i - 1 - j]
                    work[i] += pred
                if wasted:
                    work = [v << wasted for v in work]
            else:  # SF_LPC
                work = [br.read_signed(read_depth)
                        for _ in range(order)]
                precision = br.read_bits(4) + 1
                shift = br.read_bits(5)
                # Coefficient for s[i-1] is stored first
                # (zflac.zig:512-514).
                coeffs = [br.read_signed(precision) for _ in range(order)]
                work += _decode_residuals(br, block_size, order)
                for i in range(order, block_size):
                    pred = 0
                    for j in range(order):
                        pred += coeffs[j] * work[i - 1 - j]
                    work[i] += pred >> shift
                if wasted:
                    work = [v << wasted for v in work]

            # Interleave into the output (zflac.zig:443,493-497,536-540).
            # Values stay at full width until after decorrelation: the
            # reference casts to the container here, which wraps a
            # >=2^15-magnitude mid-side side channel and corrupts the
            # frame (zflac.zig:537 + :567-576); RFC 9639 keeps the side
            # channel at bps+1 bits through decorrelation.
            base = offset + channel
            for i in range(block_size):
                samples[base + channel_count * i] = work[i]

        br.align_to_byte()
        frame_crc = br.read_u16()
        if check_crc:
            body = data[frame_start_byte:br.pos // 8 - 2]
            if crc16(body) != frame_crc:
                raise InvalidChecksum("frame CRC-16 mismatch")

        # ---- stereo decorrelation (zflac.zig:553-578) ----
        if channels_code == fmt.CH_LEFT_SIDE:
            for i in range(block_size):
                idx = offset + 2 * i
                samples[idx + 1] = samples[idx] - samples[idx + 1]
        elif channels_code == fmt.CH_SIDE_RIGHT:
            for i in range(block_size):
                idx = offset + 2 * i
                samples[idx] = samples[idx] + samples[idx + 1]
        elif channels_code == fmt.CH_MID_SIDE:
            for i in range(block_size):
                idx = offset + 2 * i
                mid = (samples[idx] << 1) | (samples[idx + 1] & 1)
                s = samples[idx + 1]
                samples[idx] = (mid + s) >> 1
                samples[idx + 1] = (mid - s) >> 1

        # Container-width cast for the whole frame (zflac.zig release-mode
        # @intCast wraparound semantics).
        for i in range(offset, expected_end):
            samples[i] = _wrap(samples[i], cbits)

        offset += channel_count * block_size
        frame_count += 1

    if len(samples) != offset:
        samples = samples[:offset]

    if frame_count == 0:
        # No frames: report STREAMINFO parameters (the reference leaves
        # these undefined, zflac.zig:322-324).
        channel_count = stream_info.channel_count
        sample_rate = stream_info.sample_rate
        bits_per_sample = stream_info.bits_per_sample

    arr = np.array(samples, dtype=np.int64).astype(dtype)

    # ---- MD5 (zflac.zig:267-280): low ceil(bps/8) LE bytes per sample ----
    if verify_md5:
        nbytes = fmt.md5_bytes_per_sample(stream_info.bits_per_sample)
        raw = arr.astype("<i4").tobytes() if nbytes == 3 else arr.tobytes()
        if nbytes == 3:
            raw = b"".join(raw[i:i + 3] for i in range(0, len(raw), 4))
        if hashlib.md5(raw).digest() != stream_info.md5:
            raise InvalidChecksum("stream MD5 mismatch")

    # ---- bit-depth normalization (zflac.zig:287-306) ----
    shift = fmt.normalization_shift(stream_info.bits_per_sample)
    if shift:
        arr = (arr.astype(np.int64) << shift).astype(dtype)

    return DecodedFLAC(
        channels=channel_count,
        sample_rate=sample_rate,
        bits_per_sample=bits_per_sample,
        interleaved=arr,
        stats={"frames": frame_count},
    )
