"""Seek (partial) decode and tolerant (error-recovering) decode on the
rows engine (counterpart of zflac_tpu/runtime/seek.py).

The indexer's frame table is a seek table: decode_range reconstructs
only the frames covering a sample range, indexing from the nearest
SEEKTABLE point when the stream has one. decode_tolerant skips a
corrupt region to the next CRC-validated frame and places each decoded
segment at the exact sample position its coded number gives, with
silence in the gaps. Both reconstruct through runtime/decode.py's
_run_reconstruct on the requested device ("cuda" unless the caller
asks for another). The host pieces (indexer, metadata probe) are the
port's copies of the JAX package's modules; _slice_plan is copied from
zflac_tpu/runtime/seek.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bitio import BitReader
from ..errors import FlacError
from ..index import build_plan, native_indexer
from ..metadata import probe
from ..oracle import parse_metadata
from ..result import DecodedFLAC, container_dtype
from .decode import _assemble, _run_reconstruct, normalize
from .device import resolve_device, verify_stream_md5


def _slice_plan(plan, f0: int, f1: int):
    """Frame-range view [f0, f1) of a plan (arrays sliced, offsets
    rebased)."""
    C = plan.channels
    return dataclasses.replace(
        plan,
        block_size=plan.block_size[f0:f1],
        channel_code=plan.channel_code[f0:f1],
        pcm_start=plan.pcm_start[f0:f1] - plan.pcm_start[f0],
        frame_byte_offset=plan.frame_byte_offset[f0:f1],
        coded_number=plan.coded_number[f0:f1],
        rows=plan.rows[f0 * C:f1 * C],
        kind=plan.kind[f0 * C:f1 * C],
        order=plan.order[f0 * C:f1 * C],
        wasted=plan.wasted[f0 * C:f1 * C],
        shift=plan.shift[f0 * C:f1 * C],
        coeffs_rev=plan.coeffs_rev[f0 * C:f1 * C],
        fixed_seeds=plan.fixed_seeds[f0 * C:f1 * C],
        wide=plan.wide[f0 * C:f1 * C],
        total_samples=int(np.sum(plan.block_size[f0:f1])),
        groups=None,
    )


def decode_range(data: bytes, start_sample: int, num_samples: int,
                 prefer_native: bool = True, use_seektable: bool = True,
                 *, device="cuda") -> DecodedFLAC:
    """Decode on `device` only the frames covering [start_sample,
    start_sample + num_samples) and trim to exactly that range. The
    stream MD5 cannot be verified for a partial decode. With
    use_seektable, a SEEKTABLE point limits indexing to the needed
    byte range."""
    device = resolve_device(device)
    if use_seektable:
        r = _decode_range_indexed(data, start_sample, num_samples, device)
        if r is not None:
            return r

    plan = build_plan(data, prefer_native=prefer_native)
    end_sample = min(start_sample + num_samples, plan.total_samples)
    if start_sample >= plan.total_samples or end_sample <= start_sample:
        empty = np.zeros(0, dtype=container_dtype(
            plan.info.bits_per_sample))
        return DecodedFLAC(plan.channels, plan.sample_rate,
                           plan.bits_per_sample, empty,
                           stats={"frames": 0, "engine": "seek"})

    starts = plan.pcm_start
    f0 = int(np.searchsorted(starts, start_sample, side="right") - 1)
    f1 = int(np.searchsorted(starts, end_sample, side="left"))
    f1 = max(f1, f0 + 1)

    sub = _slice_plan(plan, f0, f1)
    interleaved = _assemble(sub, _run_reconstruct(sub, device))
    C = plan.channels
    lo = (start_sample - int(starts[f0])) * C
    hi = lo + (end_sample - start_sample) * C
    return DecodedFLAC(
        channels=C,
        sample_rate=plan.sample_rate,
        bits_per_sample=plan.bits_per_sample,
        interleaved=normalize(interleaved[lo:hi],
                              plan.info.bits_per_sample),
        stats={"frames": f1 - f0, "engine": "seek", "first_frame": f0},
    )


def _decode_range_indexed(data: bytes, start_sample: int,
                          num_samples: int, device):
    """Seek via SEEKTABLE: index only from the nearest preceding seek
    point to the end of the requested range. Returns None where this
    does not apply (no native indexer, no usable seek point, or a range
    the indexed frames do not cover)."""
    if not native_indexer.native_available():
        return None
    meta = probe(data)
    pts = [p for p in meta.seek_points if p[0] <= start_sample]
    if not pts:
        return None
    info = meta.streaminfo
    base_sample, rel_byte, _ = max(pts)
    start_byte = meta.first_frame_byte + rel_byte

    end_sample = start_sample + num_samples
    if info.total_samples:
        end_sample = min(end_sample, info.total_samples)
    if end_sample <= start_sample:
        return None

    # Index forward from the seek point, bounded by a frame-size
    # estimate first and extended only if coverage falls short.
    blk = max(info.min_block_size, 1)
    needed_frames = -(-(end_sample - base_sample) // blk) + 2
    frame_cap = max(info.max_frame_size, 1 << 16)
    stop = min(len(data), start_byte + needed_frames * frame_cap)
    plan, landed = native_indexer.index_range(data, start_byte, stop, info)
    if (base_sample + plan.total_samples < end_sample
            and landed < len(data)):
        plan, _ = native_indexer.index_range(data, start_byte, len(data),
                                             info)
    covered = base_sample
    f1 = 0
    while f1 < plan.num_frames and covered < end_sample:
        covered += int(plan.block_size[f1])
        f1 += 1
    if f1 == 0 or covered < end_sample:
        return None
    sub = _slice_plan(plan, 0, f1)

    interleaved = _assemble(sub, _run_reconstruct(sub, device))
    C = plan.channels
    lo = (start_sample - base_sample) * C
    hi = lo + (end_sample - start_sample) * C
    if lo < 0 or hi > len(interleaved):
        return None
    return DecodedFLAC(
        channels=C,
        sample_rate=plan.sample_rate,
        bits_per_sample=plan.bits_per_sample,
        interleaved=normalize(interleaved[lo:hi], info.bits_per_sample),
        stats={"frames": f1, "engine": "seektable",
               "seek_point": base_sample},
    )


def decode_tolerant(data: bytes, max_resyncs: int = 64, *,
                    device="cuda") -> DecodedFLAC:
    """Error-recovering decode on `device`: on a malformed region,
    resynchronize at the next CRC-validated frame and fill the gap with
    silence at the exact sample position recovered from coded numbers.
    Returns the best-effort PCM plus recovery stats (the MD5 result is
    reported in stats["md5_ok"], not raised)."""
    device = resolve_device(device)
    if not native_indexer.native_available():
        raise RuntimeError("tolerant decode needs the native indexer")

    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8

    segments = []
    errors = 0
    first_frame = pos
    while pos < len(data) and errors <= max_resyncs:
        # CRC checks on: the frame CRC-16 localizes damage that still
        # parses, so resync skips exactly the bad frame.
        plan, landed, exc = native_indexer.index_range(
            data, pos, len(data), info, partial_ok=True, check_crc=True)
        if plan.num_frames:
            if not segments:
                at_first_frame = pos == first_frame
            segments.append(plan)
        if exc is None:
            break
        errors += 1
        nxt = native_indexer.find_anchor(data, max(landed, pos) + 1,
                                         len(data), info)
        if nxt < 0:
            break
        pos = nxt

    if not segments:
        raise FlacError("no decodable frames found")

    C = segments[0].channels

    def first_sample(plan):
        cn = int(plan.coded_number[0])
        if plan.variable_blocking:
            return cn
        return cn * int(plan.block_size[0])

    # Segments go to their coded sample positions, as in the JAX
    # package, with one exception: when the stream's first frame
    # decoded and is numbered at or past the declared total (or no
    # total is declared), it is sample 0. Variable blocking numbers
    # frames anywhere in the 36-bit domain, and counting from 0 would
    # fill the space before the first frame with silence (64 GiB for
    # tests/test_handvectors.py's v_varblock_36bit, in the JAX
    # package). A later segment numbered before the origin starts where
    # the previous one ended.
    origin = first_sample(segments[0])
    if not at_first_frame or origin < info.total_samples:
        origin = 0
    placed, end = [], 0
    for p in segments:
        fs = first_sample(p) - origin
        fs = fs if fs >= 0 else end
        placed.append((fs, p))
        end = fs + p.total_samples
    total = max(fs + p.total_samples for fs, p in placed)
    if info.total_samples:
        total = max(total, info.total_samples)
    out = np.zeros(total * C, dtype=container_dtype(info.bits_per_sample))
    # Every segment is launched before the first is collected.
    launched = [(fs, plan, *_run_reconstruct(plan, device, async_=True))
                for fs, plan in placed]
    for fs, plan, dev, F in launched:
        part = _assemble(plan, dev[:F].cpu().numpy())
        out[fs * C:fs * C + len(part)] = part

    md5_ok = verify_stream_md5(out, info.bits_per_sample, info.md5)
    return DecodedFLAC(
        channels=C,
        sample_rate=segments[0].sample_rate,
        bits_per_sample=segments[0].bits_per_sample,
        interleaved=normalize(out, info.bits_per_sample),
        stats={"engine": "tolerant", "resyncs": errors,
               "segments": len(segments), "md5_ok": md5_ok,
               "frames": sum(p.num_frames for p in segments)},
    )
