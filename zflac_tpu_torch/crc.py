"""FLAC frame CRCs.

CRC-8  poly x^8 + x^2 + x^1 + x^0 (0x07), init 0, MSB-first — covers the
frame header up to (excluding) the CRC byte (RFC 9639 §9.1; the reference
reads but does not verify it, zflac.zig:407-410).

CRC-16 poly x^16 + x^15 + x^2 + x^0 (0x8005), init 0, MSB-first — covers
the whole frame excluding the trailing CRC (zflac.zig:548-551, also
unverified there).

This engine goes beyond the reference: both CRCs are *verified* by the
native indexer (and by this module's Python fallback) when crc checking
is enabled.

The port's copy of zflac_tpu/crc.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations


def _make_table(poly: int, width: int) -> list[int]:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table.append(crc & mask)
    return table


CRC8_TABLE = _make_table(0x07, 8)
CRC16_TABLE = _make_table(0x8005, 16)


def crc8(data: bytes, crc: int = 0) -> int:
    table = CRC8_TABLE
    for b in data:
        crc = table[crc ^ b]
    return crc


def crc16(data: bytes, crc: int = 0) -> int:
    table = CRC16_TABLE
    for b in data:
        crc = table[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc
