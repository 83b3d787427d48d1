"""Long-stream decode: the time axis sharded across byte ranges at
frame granularity (counterpart of zflac_tpu/parallel/longstream.py).

Pipeline per shard h of H:
  1. STREAMINFO is parsed once.
  2. shard h owns byte range [r_h, r_{h+1}); it locates its first frame
     with the sync-scan + CRC-validated anchor search (frame resync)
     and indexes whole frames up to the next shard's anchor.
  3. boundary exchange: each shard contributes
     (anchor, landed, frames, samples); gathered, these give every
     participant the global picture, a prefix sum over the sample
     counts assigns global PCM offsets, and chain consistency
     (landed_h == anchor_{h+1}) is verified.
  4. each shard reconstructs its frames with the rows engine, shard h
     on mesh[h % D], and writes its slice of the output.
  5. stream MD5 over the assembled PCM (sequential by definition; host).

In one process the gather of step 3 is a no-op; across processes
(parallel/distributed.py) the same function gathers the rows with
torch.distributed.all_gather, each process reading only its byte range.
"""

from __future__ import annotations

import numpy as np

from ..bitio import BitReader
from ..errors import InvalidFrameHeader
from ..index.native_indexer import find_anchor, index_range
from ..oracle import parse_metadata
from ..result import DecodedFLAC, container_dtype
from ..runtime.decode import _assemble, _finish, _run_reconstruct
from ..utils.log import get_logger
from .shard import make_mesh

_log_shard = get_logger("shard")


def range_starts(data: bytes, first: int, info, num_ranges: int) -> list:
    """The deterministic anchor table: the stream's bytes from `first`
    split into `num_ranges` equal windows, each but the first replaced
    by the first CRC-validated frame start inside it. A window that
    holds no frame start contributes nothing (its bytes belong to the
    range before it). Returns the sorted range starts."""
    span = len(data) - first
    bounds = [first + span * h // num_ranges for h in range(num_ranges + 1)]
    anchors = [first] + [find_anchor(data, bounds[h], bounds[h + 1], info)
                         for h in range(1, num_ranges)]
    return sorted(set(a for a in anchors if a >= 0))


def shard_index(data: bytes, num_shards: int, check_crc: bool = False):
    """Steps 1-2: per-shard range indexing. Returns (info, list of
    (anchor, landed, plan_shard))."""
    br = BitReader(data)
    info = parse_metadata(br)
    starts = range_starts(data, br.pos // 8, info, num_shards)

    shards = []
    for i, a in enumerate(starts):
        stop = starts[i + 1] if i + 1 < len(starts) else len(data)
        plan, landed = index_range(data, a, stop, info,
                                   check_crc=check_crc)
        _log_shard.debug("shard %d: anchor=%d landed=%d frames=%d "
                         "samples=%d", i, a, landed, plan.num_frames,
                         plan.total_samples)
        shards.append((a, landed, plan))
    return info, shards


def boundary_exchange(rows, gather=None):
    """Step 3: gather the participants' boundary rows and verify chain
    consistency. `rows` is this participant's int64 array [K, 4] of
    (anchor, landed, frames, samples), an anchor of -1 (and no samples)
    marking a participant whose window held no frame; `gather` maps the
    flat rows to every participant's, stacked in rank order (None
    inside one process, where `rows` already holds every shard).
    Returns (the table [H, 4], each row's global PCM offset in samples
    [H]); raises InvalidFrameHeader when a shard did not land on the
    next one's anchor."""
    table = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    if gather is not None:
        table = np.asarray(gather(table.reshape(-1))).reshape(-1, 4)
    live = table[table[:, 0] >= 0]
    # Chain consistency: each shard's landing byte must be the next
    # shard's anchor (no gaps, no overlaps).
    for h in range(len(live) - 1):
        if live[h, 1] != live[h + 1, 0]:
            raise InvalidFrameHeader(
                f"shard {h} landed at {live[h, 1]}, next anchor "
                f"{live[h + 1, 0]}")
    samples = table[:, 3]
    return table, np.cumsum(samples) - samples


def decode_longstream(data: bytes, num_shards: int, mesh,
                      check_crc: bool = False, verify_md5: bool = True):
    """Steps 1-5 in one process: shard h is reconstructed by the rows
    engine on mesh[h % D], every shard launched before the first is
    collected. A CUDA device of the mesh with no card raises."""
    mesh = make_mesh(mesh)
    info, shards = shard_index(data, num_shards, check_crc=check_crc)
    _, offsets = boundary_exchange(
        [(a, landed, plan.num_frames, plan.total_samples)
         for a, landed, plan in shards])

    total = sum(p.total_samples for _, _, p in shards)
    channels = shards[0][2].channels
    out = np.empty(total * channels,
                   dtype=container_dtype(info.bits_per_sample))
    launched = [_run_reconstruct(plan, mesh[h % len(mesh)], async_=True)
                for h, (_, _, plan) in enumerate(shards)]
    for (_, _, plan), (pcm, F), offset in zip(shards, launched, offsets):
        part = _assemble(plan, pcm[:F].cpu().numpy())
        start = int(offset) * channels
        out[start:start + len(part)] = part

    out = _finish(out, info.bits_per_sample, info.md5, verify_md5)
    return DecodedFLAC(
        channels=channels,
        sample_rate=shards[0][2].sample_rate,
        bits_per_sample=shards[0][2].bits_per_sample,
        interleaved=out,
        stats={"shards": len(shards),
               "frames": sum(p.num_frames for _, _, p in shards),
               "engine": "longstream"},
    )
