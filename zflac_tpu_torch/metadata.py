"""Metadata block parsing: STREAMINFO plus the blocks the reference
merely skips (Padding/Application/Seektable/VorbisComment/Cuesheet/
Picture, zflac.zig:243-247) surfaced as structured data.

The port's copy of zflac_tpu/metadata.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import format as fmt
from .bitio import BitReader
from .errors import InvalidMetadataHeader, MissingStreaminfo


@dataclass
class StreamMetadata:
    streaminfo: fmt.StreamInfo
    #: [(sample_number, byte_offset, frame_samples)] from SEEKTABLE
    seek_points: list = field(default_factory=list)
    vendor: str = ""
    #: Vorbis comments as {KEY: [values...]} (keys uppercased)
    tags: dict = field(default_factory=dict)
    #: [(picture_type, mime, description, width, height, size_bytes)]
    pictures: list = field(default_factory=list)
    #: [(application_id, payload_length)]
    applications: list = field(default_factory=list)
    has_cuesheet: bool = False
    padding_bytes: int = 0
    #: Byte offset of the first audio frame
    first_frame_byte: int = 0


def probe(data: bytes) -> StreamMetadata:
    """Parse the metadata section without touching audio frames."""
    br = BitReader(data)
    if br.read_u32() != fmt.SIGNATURE:
        from .errors import InvalidSignature
        raise InvalidSignature()

    streaminfo = None
    meta = None
    seek_points = []
    vendor = ""
    tags: dict = {}
    pictures = []
    applications = []
    has_cuesheet = False
    padding = 0

    while True:
        header_byte = br.read_u8()
        last = bool(header_byte & 0x80)
        block_type = header_byte & 0x7F
        length = br.read_u24()
        body_start = br.byte_pos()

        if block_type == fmt.META_STREAMINFO:
            from .oracle import parse_streaminfo
            streaminfo = parse_streaminfo(br)
        elif block_type == fmt.META_SEEKTABLE:
            raw = br.read_bytes(length)
            for i in range(0, (length // 18) * 18, 18):
                sample = int.from_bytes(raw[i:i + 8], "big")
                offset = int.from_bytes(raw[i + 8:i + 16], "big")
                nsamp = int.from_bytes(raw[i + 16:i + 18], "big")
                if sample != 0xFFFFFFFFFFFFFFFF:  # placeholder points
                    seek_points.append((sample, offset, nsamp))
        elif block_type == fmt.META_PADDING:
            padding += length
            br.skip_bytes(length)
        elif block_type == fmt.META_APPLICATION:
            app_id = br.read_bytes(4)
            applications.append((app_id, length - 4))
            br.skip_bytes(length - 4)
        elif block_type == fmt.META_VORBIS_COMMENT:
            # Vorbis comments are little-endian length-prefixed strings.
            raw = br.read_bytes(length)
            try:
                n = int.from_bytes(raw[0:4], "little")
                vendor = raw[4:4 + n].decode("utf-8", "replace")
                p = 4 + n
                count = int.from_bytes(raw[p:p + 4], "little")
                p += 4
                for _ in range(count):
                    ln = int.from_bytes(raw[p:p + 4], "little")
                    p += 4
                    entry = raw[p:p + ln].decode("utf-8", "replace")
                    p += ln
                    if "=" in entry:
                        key, val = entry.split("=", 1)
                        tags.setdefault(key.upper(), []).append(val)
            except (IndexError, ValueError):
                pass  # malformed comments are non-fatal (skippable block)
        elif block_type == fmt.META_CUESHEET:
            has_cuesheet = True
            br.skip_bytes(length)
        elif block_type == fmt.META_PICTURE:
            raw = BitReader(br.read_bytes(length))
            try:
                ptype = raw.read_u32()
                mlen = raw.read_u32()
                mime = raw.read_bytes(mlen).decode("ascii", "replace")
                dlen = raw.read_u32()
                desc = raw.read_bytes(dlen).decode("utf-8", "replace")
                width = raw.read_u32()
                height = raw.read_u32()
                raw.read_u32()  # depth
                raw.read_u32()  # colors
                size = raw.read_u32()
                pictures.append((ptype, mime, desc, width, height, size))
            except Exception:
                pass
        elif block_type <= fmt.META_MAX_VALID:
            br.skip_bytes(length)
        else:
            raise InvalidMetadataHeader()

        # Defensive: ensure we consumed exactly `length` bytes.
        consumed = br.byte_pos() - body_start
        if consumed != length:
            br.pos = (body_start + length) * 8

        if last:
            break

    if streaminfo is None:
        raise MissingStreaminfo()
    meta = StreamMetadata(
        streaminfo=streaminfo,
        seek_points=seek_points,
        vendor=vendor,
        tags=tags,
        pictures=pictures,
        applications=applications,
        has_cuesheet=has_cuesheet,
        padding_bytes=padding,
        first_frame_byte=br.byte_pos(),
    )
    return meta
