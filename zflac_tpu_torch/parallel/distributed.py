"""Multi-process (multi-host) decode over torch.distributed
(counterpart of zflac_tpu/parallel/distributed.py).

The boundary-exchange design of longstream.py with the shards in
DIFFERENT PROCESSES, each with its own devices. Every table that
crosses processes is host data on both ends (boundary rows, chunk
geometry, block sizes, PCM slices), so the collectives run on CPU
tensors over the gloo backend, also when the decode itself runs on a
card; int64 counters cross as they are.

Per process p of P (after torch.distributed.init_process_group; a
process outside any group is a world of one):
  1. every process parses STREAMINFO and computes the deterministic
     anchor table (sync-scan + CRC-validated frame starts at the P
     byte-range boundaries): header-scan work only, no decode;
  2. process p indexes and decodes ONLY its own byte range
     [anchor_p, anchor_{p+1});
  3. boundary rows (anchor, landed, frames, samples) cross processes
     via all_gather; every process computes the same prefix-sum PCM
     offsets and verifies chain consistency
     (landed_p == anchor_{p+1}: no gaps, no overlaps);
  4. per-shard PCM slices cross via a second all_gather (padded to the
     longest shard, int32 lanes);
  5. every process assembles the full PCM, verifies the stream MD5 and
     returns an identical DecodedFLAC.

Run one process standalone:
  python -m zflac_tpu_torch.parallel.distributed <stream.flac> <out.npy> \\
      <coordinator host:port> <rank> <world size> [longstream|pack2] \\
      [local devices, comma separated; default: every visible CUDA device]
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from ..bitio import BitReader
from ..errors import InvalidChecksum, InvalidFrameHeader
from ..index import native_indexer
from ..index.native_indexer import PACK2_CLASSES
from ..oracle import parse_metadata
from ..result import DecodedFLAC, container_dtype
from ..runtime.decode import (_assemble, _finish, _pad_pow2,
                              _run_reconstruct)
from ..runtime.device import (_bucket_block, apply_stop_cut, chunk_parts,
                              reconstruct_chunks, resolve_device)
from ..utils.log import get_logger
from .longstream import boundary_exchange, range_starts
from .shard import chunk_samples, make_mesh, require_one_geometry

_log_shard = get_logger("shard")

# How long a collective waits for the other processes. One that raised
# before reaching it never arrives: the rest fail here instead of
# hanging.
GROUP_TIMEOUT_S = 120


def _world() -> tuple:
    """(rank, world size) of this process; (0, 1) outside any process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_rows(local_row: np.ndarray) -> np.ndarray:
    """Gather one row per PROCESS: local_row [K] (any integer dtype,
    the same K everywhere) -> [num_processes, K] in rank order,
    identical on every process. One all_gather of CPU tensors."""
    row = np.ascontiguousarray(local_row)
    world = _world()[1]
    if world == 1 or row.size == 0:
        return np.tile(row[None, :], (world, 1))
    t = torch.from_numpy(row)
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _allreduce_sum(value: int) -> int:
    """The sum of every process's `value`."""
    t = torch.tensor([value], dtype=torch.int64)
    if _world()[1] > 1:
        dist.all_reduce(t)
    return int(t)


def decode_longstream_distributed(data: bytes, check_crc: bool = False,
                                  verify_md5: bool = True, *,
                                  device="cuda"):
    """Steps 1-5 above, this process's range reconstructed by the rows
    engine on `device`. Call in every process of an initialized
    torch.distributed job; every process returns the full result."""
    device = resolve_device(device)
    p, Pn = _world()

    # 1. deterministic anchor table (identical in every process).
    br = BitReader(data)
    info = parse_metadata(br)
    starts = range_starts(data, br.pos // 8, info, Pn)

    # 2. index + decode only our own range.
    if p < len(starts):
        a = starts[p]
        stop = starts[p + 1] if p + 1 < len(starts) else len(data)
        plan, landed = native_indexer.index_range(
            data, a, stop, info, check_crc=check_crc)
        part = _assemble(plan, _run_reconstruct(plan, device))
        row64 = np.array([a, landed, plan.num_frames,
                          plan.total_samples], dtype=np.int64)
    else:  # empty shard (window held no frame start)
        part = np.zeros(0, dtype=container_dtype(info.bits_per_sample))
        row64 = np.array([-1, -1, 0, 0], dtype=np.int64)

    # 3. boundary exchange + chain verify (identical result everywhere).
    table, offsets = boundary_exchange(row64, gather=_allgather_rows)
    _log_shard.debug("process %d/%d boundary rows: %s", p, Pn,
                     table.tolist())
    samples = table[:, 3]

    # 4. PCM exchange: pad each slice to the global max (in int32
    # lanes; container dtypes are narrower or equal).
    channels = info.channel_count
    max_vals = int(samples.max(initial=0)) * channels
    padded = np.zeros(max_vals, dtype=np.int32)
    padded[:len(part)] = part
    gathered = _allgather_rows(padded)  # [Pn, max_vals]

    # 5. assemble + verify (every process identically; an empty
    # shard's row holds no samples).
    dtype = container_dtype(info.bits_per_sample)
    out = np.empty(int(samples.sum()) * channels, dtype=dtype)
    for h in range(Pn):
        n = int(samples[h]) * channels
        start = int(offsets[h]) * channels
        out[start:start + n] = gathered[h, :n].astype(dtype)

    out = _finish(out, info.bits_per_sample, info.md5, verify_md5)
    return DecodedFLAC(
        channels=channels,
        sample_rate=info.sample_rate,
        bits_per_sample=info.bits_per_sample,
        interleaved=out,
        stats={"shards": int((table[:, 0] >= 0).sum()), "processes": Pn,
               "frames": int(table[:, 2].sum()),
               "engine": "longstream-distributed"},
    )


def union_chunks(data: bytes, info, first: int, num_local: int,
                 check_crc: bool = False):
    """Steps 1-3 of decode_pack2_distributed: this process's pack2
    chunks, one per local byte range, scanned in the geometry that
    every chunk of every process shares. Returns (the range starts,
    the chunks), or (the range starts, None) when some process's range
    declined the scan or was left without a frame start; the flag is
    exchanged, so every process gets None together. Raises
    InvalidFrameHeader, in every process, when a forced re-scan does
    not land on its range's end."""
    p, Pn = _world()
    L = num_local

    # 1. anchor table over P*L ranges (identical in every process).
    starts = range_starts(data, first, info, Pn * L)
    ranges = [(starts[d], starts[d + 1] if d + 1 < len(starts)
               else len(data))
              for d in range(p * L, (p + 1) * L) if d < len(starts)]

    # 2. natural-geometry scan of our local ranges.
    cks = []
    ok = 1
    for a, stop in ranges:
        ck = native_indexer.pack2_range(
            data, a, stop, info, check_crc=check_crc, max_frames=1 << 20)
        if ck is None or ck.landed < stop:
            ok = 0
        else:
            cks.append(ck)
    if not cks:
        # A process with zero anchor ranges has no chunk to size a
        # buffer from: everyone falls back to the longstream path,
        # which handles empty shards.
        ok = 0

    # 3. geometry union exchange: per process, the max over its local
    # chunks of every capacity plus the ok flag.
    def cap(fn, default=0):
        return max((fn(ck) for ck in cks), default=default)

    def class_n(ck, name):
        return dict((n, cn) for n, cn, _ in ck.classes).get(name, 0)

    row = np.array(
        [ok, cap(lambda c: c.F), cap(lambda c: c.B),
         cap(lambda c: c.W, 8), cap(lambda c: c.n_patch_p),
         cap(lambda c: int(c.wide))] +
        [cap(lambda c, n=n: class_n(c, n)) for n in PACK2_CLASSES],
        dtype=np.int64)
    g = _allgather_rows(row)  # [Pn, 6 + n_classes]
    if not int(g[:, 0].min()):
        return starts, None
    FpU = _pad_pow2(max(1, int(g[:, 1].max())))
    BpU = _bucket_block(max(int(g[:, 2].max()), 16))
    WU = int(g[:, 3].max())
    n_patch_pU = int(g[:, 4].max())
    wideU = bool(g[:, 5].max())
    cnpU = [int(g[:, 6 + i].max()) for i in range(len(PACK2_CLASSES))]

    # Re-scan with the forced union geometry: the class-sorted buffer
    # layout is deterministic given (Fp, Bp, W, class caps, patch cap,
    # wide), so every process derives the same section offsets.
    cks = [native_indexer.pack2_range(
               data, a, stop, info, check_crc=check_crc, max_frames=FpU,
               force_fp=FpU, force_bp=BpU, force_w=WU, force_class_np=cnpU,
               force_patch_np=n_patch_pU, force_wide=wideU)
           for a, stop in ranges]
    # The union geometry only widens capacities, so a forced re-scan of
    # a range that succeeded naturally must land at the same stop. A
    # violation means the processes would disagree on the buffer
    # layout: proceeding would produce corrupt PCM, and a fallback or
    # a raise in one process alone would leave the others waiting in a
    # collective. So the outcome is exchanged, and every process raises
    # when any range of any process landed elsewhere. Not an assert: it
    # must survive python -O.
    missed = [(a, stop, getattr(ck, "landed", None))
              for (a, stop), ck in zip(ranges, cks)
              if ck is None or ck.landed != stop]
    landed = _allgather_rows(np.array([not missed], dtype=np.int64))[:, 0]
    if not landed.all():
        where = "; ".join(f"[{a}, {stop}) landed at {at}"
                          for a, stop, at in missed) or "another process"
        raise InvalidFrameHeader(
            f"pack2 union re-scan in process(es) "
            f"{np.flatnonzero(landed == 0).tolist()}: {where} "
            "(geometry mismatch)")
    require_one_geometry(cks)
    return starts, cks


def decode_pack2_distributed(data: bytes, check_crc: bool = False,
                             verify_md5: bool = True, *, devices=None):
    """Multi-process decode through the pack2 device path: one packed
    chunk per device of every process, with the completeness count
    reduced across processes. `devices` are this process's local
    devices (default: every visible CUDA device), the same number L in
    every process.

    Per process p of P:
      1. anchor table over P*L byte ranges (identical everywhere);
      2. process p scans its L ranges with the C++ pack2 scan (natural
         geometry);
      3. the chunk GEOMETRY (frame/patch/class counts, W, wide flag)
         is gathered so every process computes the same union; each
         process re-scans its ranges with the forced union geometry,
         and whether every re-scan landed on its range's end is
         gathered too;
      4. chunk l is uploaded to and reconstructed on local device l,
         all queued before any is waited for, and the sample counts
         the buffers carry are summed on the devices and all_reduced;
      5. per-process PCM and block-size tables cross via all_gather;
         every process assembles the full stream, applies the
         reference's STREAMINFO-total stop semantics, verifies MD5,
         and returns an identical DecodedFLAC.

    Falls back to decode_longstream_distributed when any process's
    range declines the pack2 scan (the flag itself is exchanged, so
    every process takes the same branch)."""
    devices = make_mesh(devices)
    Pn = _world()[1]
    br = BitReader(data)
    info = parse_metadata(br)
    starts, cks = union_chunks(data, info, br.pos // 8, len(devices),
                               check_crc=check_crc)
    if cks is None:
        return decode_longstream_distributed(
            data, check_crc=check_crc, verify_md5=verify_md5,
            device=devices[0])

    # 4. one upload and one reconstruction per local device, all
    # queued; then the completeness count.
    counts = []
    launched = reconstruct_chunks(
        cks, devices,
        each=lambda buf, geom: counts.append(chunk_samples(buf, geom)))
    psum_total = _allreduce_sum(sum(int(c) for c in counts))

    # 5. PCM + frame-table exchange, assembly, stop semantics, MD5.
    C = info.channel_count
    flat_parts = [np.zeros(0, np.int32)]
    bs_parts = [np.zeros(0, np.int32)]
    for ck, pcm in zip(cks, launched):
        flat_parts += chunk_parts(pcm[:ck.F].cpu().numpy(), ck.F,
                                  ck.f_block_size)
        bs_parts.append(ck.f_block_size[:ck.F])
    my_pcm = np.concatenate(flat_parts).astype(np.int32)
    my_bs = np.concatenate(bs_parts).astype(np.int32)

    # lengths first (so rows can be padded identically everywhere)
    lens = _allgather_rows(np.array([len(my_pcm), len(my_bs)],
                                    dtype=np.int64))  # [Pn, 2]
    pad_pcm = np.zeros(int(lens[:, 0].max()), np.int32)
    pad_pcm[:len(my_pcm)] = my_pcm
    pad_bs = np.zeros(int(lens[:, 1].max()), np.int32)
    pad_bs[:len(my_bs)] = my_bs
    g_pcm = _allgather_rows(pad_pcm)   # [Pn, max_pcm]
    g_bs = _allgather_rows(pad_bs)     # [Pn, max_bs]

    all_bs = np.concatenate([g_bs[h, :int(lens[h, 1])] for h in range(Pn)])
    out32 = np.concatenate([g_pcm[h, :int(lens[h, 0])] for h in range(Pn)])
    # Cross-process completeness invariant: the reduced count of the
    # samples the devices' buffers carried must equal the gathered
    # frame tables' total. A mismatch means a device decoded different
    # geometry than its process reported, so fail loudly (not an
    # assert: it must survive python -O).
    decoded = int(all_bs.sum(dtype=np.int64))
    if psum_total != decoded * C:
        raise InvalidChecksum(
            f"pack2 distributed sample-count mismatch: psum "
            f"{psum_total} != frame tables {decoded * C}")

    # Reference stop semantics at the STREAMINFO total.
    if info.total_samples and decoded > info.total_samples:
        cut = apply_stop_cut([all_bs], info.total_samples)
        if cut is not None:
            out32 = out32[:cut[2] * C]

    out = _finish(out32.astype(container_dtype(info.bits_per_sample)),
                  info.bits_per_sample, info.md5, verify_md5)
    return DecodedFLAC(
        channels=C,
        sample_rate=info.sample_rate,
        bits_per_sample=info.bits_per_sample,
        interleaved=out,
        stats={"shards": len(starts), "processes": Pn,
               "frames": int(len(all_bs)),
               "engine": "pack2-distributed"},
    )


def _worker_main(argv) -> int:
    stream_path, out_path, coordinator, rank, world = argv[:5]
    engine = argv[5] if len(argv) > 5 else "longstream"
    devices = argv[6].split(",") if len(argv) > 6 else None
    # One intra-op thread: several workers share a host's cores.
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=int(rank),
        world_size=int(world),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(stream_path, "rb") as f:
            data = f.read()
        if engine == "pack2":
            r = decode_pack2_distributed(data, devices=devices)
        else:
            r = decode_longstream_distributed(
                data, device=make_mesh(devices)[0])
        np.save(out_path, r.interleaved)
        print(f"process {rank}/{world}: {r.stats}; kernel launches "
              f"{dict(_kernels.launches)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_worker_main(sys.argv[1:]))
