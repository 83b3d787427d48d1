"""The rows engine's decode entry points in PyTorch (counterpart of
zflac_tpu/runtime/decode.py): bytes -> host index -> device
reconstruction -> assembly -> MD5 -> DecodedFLAC.

The host indexer (index.build_plan, or index_range for a byte range;
the port's copy of the JAX package's) builds a StreamPlan.
_run_reconstruct pads it to the shapes the kernels need (pad_plan: the
time axis to a multiple of 8, sentinel-padded class lists of whole
warp-blocks), packs it into one buffer (runtime/pack.py) and uploads
that in one pinned, non-blocking copy, reconstructs [F, B, C] PCM on
the device
(runtime/reconstruct.py: the lpc kernel at int32, lpc64 at int64,
the fixed class as lanes of the lpc class's launch) and copies it back
for assembly on the host.

decode_pipelined and stream_decode overlap host indexing with device
work through the ordinary asynchrony of one CUDA stream: uploads and
launches return at once, and the device-to-host copy in the collection
loop waits for each chunk.

Every entry point runs on the card (device="cuda") unless the caller
passes another device. This module imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import format as fmt
from ..bitio import BitReader
from ..errors import InvalidChecksum
from ..index import build_plan, native_indexer
from ..oracle import parse_metadata
from ..plan import StreamPlan
from ..result import DecodedFLAC, container_dtype
from ..utils.log import get_logger
from ..utils.profiler import maybe_trace
from ..utils.timer import count, recording, span
from .device import (estimate_total_frames, resolve_device, upload,
                     verify_stream_md5)
from .pack import Packer
from .reconstruct import reconstruct_packed

_log_stream = get_logger("stream")
_log_frame = get_logger("frame")
_log_kernel = get_logger("kernel")

ENGINES = ("torch", "native")
# The plan arrays the card receives, rows first (at offset 0 of the
# packed buffer). The plan's kind and fixed_seeds stay on the host: the
# class lists carry the kind, and the fixed rows' warm-ups replace the
# seeds (reconstruct.lpc_lanes_inputs).
PLAN_ARRAYS = ("rows", "order", "wasted", "shift", "coeffs", "channel_code")


# The lpc kernels run the time axis in groups of 8 steps (ops/lpc.py).
TIME_GROUP = 8
# Class lists are padded to whole warp-blocks of lanes: the lpc ring's
# kLanes (csrc/lpc_ring.cuh), so every lane slice of a gathered class
# keeps the row stride that allows its 16-byte cp.async copies.
CLASS_GROUP = 32


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_plan(plan: StreamPlan):
    """The PLAN_ARRAYS in the shapes the rows engine's kernels need:
    rows [S, B8] with B8 = B rounded up to a multiple of TIME_GROUP
    (zero columns after each block, which change nothing before them);
    the per-subframe arrays at their length S and channel_code at F, as
    the plan holds them (not copies); each nonempty class's gather list
    padded with the sentinel S to a multiple of CLASS_GROUP. The JAX
    package pads F to a power of two, B to a multiple of 128 and every
    class list to a power of two, so that XLA compiles few shapes; the
    port compiles nothing per shape. Returns (arrays: name -> numpy,
    class_idx: name -> int32 numpy)."""
    S = plan.num_subframes
    B = plan.max_block
    rows = np.zeros((S, _round_up(B, TIME_GROUP)), dtype=plan.rows.dtype)
    rows[:, :B] = plan.rows
    arrays = dict(rows=rows, order=plan.order, wasted=plan.wasted,
                  shift=plan.shift, coeffs=plan.coeffs_rev,
                  channel_code=plan.channel_code)
    class_idx = {}
    for name, idx in plan.classes().items():
        if len(idx) == 0:
            continue
        padded = np.full(_round_up(len(idx), CLASS_GROUP), S, dtype=np.int32)
        padded[:len(idx)] = idx
        class_idx[name] = padded
    return arrays, class_idx


@dataclass
class StagedPlan:
    """A plan padded and packed on the host, ready for the device: one
    int32 buffer `buf` (int64 rows as word pairs) laid out as `spec`
    says (runtime/pack.py), the classes present (`class_names`, buffer
    entries "ci_<name>") and reconstruct_packed's static arguments
    `kw`."""
    kw: dict
    buf: np.ndarray
    spec: tuple
    class_names: tuple


def stage_arrays(arrays: dict, class_idx: dict, kw: dict) -> StagedPlan:
    """Pack pad_plan's PLAN_ARRAYS and class lists (or a device's slice
    of shard_plan's) into one buffer, rows first."""
    p = Packer()
    for name in PLAN_ARRAYS:
        p.add(name, arrays[name])
    for name, idx in class_idx.items():
        p.add("ci_" + name, idx)
    buf, spec = p.finish()
    return StagedPlan(kw, buf, spec, tuple(sorted(class_idx)))


def stage_plan(plan: StreamPlan) -> StagedPlan:
    """The host half of _run_reconstruct: pad the plan and pack it into
    one buffer. Counts `fixed_lanes`, the plan's fixed subframes (all
    run as lanes of an lpc kernel launch, reconstruct_core), in the
    open call."""
    count("fixed_lanes", int(np.count_nonzero(plan.kind == fmt.SF_FIXED)))
    arrays, class_idx = pad_plan(plan)
    kw = dict(
        num_channels=plan.channels,
        container_bits=fmt.container_bits(plan.info.bits_per_sample),
        do_decorrelate=bool(
            np.any(plan.channel_code > fmt.CH_INDEPENDENT_MAX)))
    return stage_arrays(arrays, class_idx, kw)


def launch_plan(staged: StagedPlan, device):
    """The device half: upload the staged plan's buffer to `device` (one
    copy) and queue its reconstruction. Returns the PCM tensor
    [F, B8, C] without waiting for it. Records `reconstruct_upload_ms`
    and `reconstruct_launch_ms` in the open call (utils/timer.py)."""
    with span("reconstruct.upload"):
        buf = upload(staged.buf, device)
    with span("reconstruct.launch"):
        return reconstruct_packed(buf, spec=staged.spec,
                                  class_names=staged.class_names,
                                  **staged.kw)


def _run_reconstruct(plan: StreamPlan, device, async_: bool = False):
    """Pad the plan, upload it to `device` and reconstruct it there.
    Returns host PCM [F, B8, C] (container dtype), or (device tensor
    [F, B8, C], F) when async_ (launched, not waited for). Records
    `reconstruct_stage_ms` (padding and packing) and, when it waits,
    `reconstruct_wait_ms` (the device-to-host copy, which waits for the
    device) in the open call (utils/timer.py)."""
    with span("reconstruct.stage"):
        staged = stage_plan(plan)
    pcm = launch_plan(staged, device)
    if async_:
        return pcm, plan.num_frames
    with span("reconstruct.wait"):
        return pcm[:plan.num_frames].cpu().numpy()


def _assemble(plan: StreamPlan, pcm: np.ndarray) -> np.ndarray:
    """[F, B, C] frame-major PCM -> interleaved output, honoring
    per-frame block sizes."""
    F = plan.num_frames
    C = plan.channels
    bs = plan.block_size
    total = plan.total_samples
    if F == 0:
        return np.zeros(0, dtype=pcm.dtype if pcm.size else np.int16)
    if np.all(bs == bs[0]):
        flat = pcm[:, :bs[0], :].reshape(-1)
        return flat[:total * C]
    out = np.empty(total * C, dtype=pcm.dtype)
    for f in range(F):
        start = plan.pcm_start[f] * C
        out[start:start + bs[f] * C] = pcm[f, :bs[f], :].reshape(-1)
    return out


def _chunk_bytes_estimate(data: bytes, pos: int, info,
                          chunk_frames: int) -> int:
    """Bytes per pipeline chunk for ~chunk_frames frames. An unknown
    STREAMINFO total (0) takes the probe-scan frame estimate, so the
    stream still splits into chunks."""
    if info.total_samples:
        nominal = max(info.max_block_size, 1)
        total_frames = max(1, -(-info.total_samples // nominal))
    else:
        total_frames = estimate_total_frames(data, pos, info) or 1
    return max(1 << 16,
               (len(data) - pos) * chunk_frames // total_frames)


def normalize(out: np.ndarray, bps: int) -> np.ndarray:
    """The bit-depth normalization (zflac.zig:287-306; wraps in the
    container)."""
    shift = fmt.normalization_shift(bps)
    return out << shift if shift else out


def _finish(out: np.ndarray, bps: int, md5: bytes,
            verify_md5: bool) -> np.ndarray:
    """The MD5 check (raises InvalidChecksum), then normalize; records
    `finish_md5_ms` and `finish_normalize_ms` in the open call."""
    if verify_md5:
        with span("finish.md5"):
            ok = verify_stream_md5(out, bps, md5)
        if not ok:
            raise InvalidChecksum("stream MD5 mismatch")
    with span("finish.normalize"):
        return normalize(out, bps)


def decode_pipelined(data: bytes, chunk_frames: int = 64,
                     verify_md5: bool = True, *,
                     device="cuda") -> DecodedFLAC:
    """Chunked decode on `device`: the host indexes chunk i+1 while the
    device reconstructs chunk i (each chunk's uploads and launches are
    queued without waiting, and collected in order afterwards)."""
    device = resolve_device(device)
    if not native_indexer.native_available():
        return decode(data, verify_md5=verify_md5, engine="torch",
                      device=device)

    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    chunk_bytes = _chunk_bytes_estimate(data, pos, info, chunk_frames)

    launched = []  # (plan, device pcm, F)
    while pos < len(data):
        stop = min(pos + chunk_bytes, len(data))
        plan, landed = native_indexer.index_range(data, pos, stop, info)
        if plan.num_frames == 0:
            break
        dev, F = _run_reconstruct(plan, device, async_=True)
        launched.append((plan, dev, F))
        if landed <= pos:
            break
        pos = landed

    if not launched:
        return decode(data, verify_md5=verify_md5, engine="torch",
                      device=device)

    C = launched[0][0].channels
    total = sum(p.total_samples for p, _, _ in launched)
    out = np.empty(total * C, dtype=container_dtype(info.bits_per_sample))
    at = 0
    for plan, dev, F in launched:
        part = _assemble(plan, dev[:F].cpu().numpy())  # waits for it
        out[at:at + len(part)] = part
        at += len(part)

    out = _finish(out, info.bits_per_sample, info.md5, verify_md5)
    return DecodedFLAC(
        channels=C,
        sample_rate=launched[0][0].sample_rate,
        bits_per_sample=launched[0][0].bits_per_sample,
        interleaved=out,
        stats={"engine": "pipelined", "chunks": len(launched),
               "frames": sum(p.num_frames for p, _, _ in launched)},
    )


def stream_decode(data: bytes, chunk_frames: int = 64, *,
                  device="cuda"):
    """Streaming decode on `device`: yields interleaved PCM chunks
    (normalized container samples) as they are produced, chunk i+1
    indexed and launched before chunk i is collected."""
    device = resolve_device(device)
    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8

    if not native_indexer.native_available():
        yield decode(data, verify_md5=False, engine="torch",
                     device=device).interleaved
        return

    chunk_bytes = _chunk_bytes_estimate(data, pos, info, chunk_frames)

    def collect(p, dev, F):
        return normalize(_assemble(p, dev[:F].cpu().numpy()),
                         info.bits_per_sample)

    pending = None  # (plan, device pcm, F)
    while pos < len(data):
        stop = min(pos + chunk_bytes, len(data))
        plan, landed = native_indexer.index_range(data, pos, stop, info)
        if plan.num_frames == 0:
            break
        launched = (plan, *_run_reconstruct(plan, device, async_=True))
        if pending is not None:
            yield collect(*pending)
        pending = launched
        if landed <= pos:
            break
        pos = landed
    if pending is not None:
        yield collect(*pending)


def _decode_native(data: bytes, check_crc: bool,
                   verify_md5: bool) -> DecodedFLAC:
    """The host engine (the port's copy of the JAX package's native
    library): parallel sync-scan index and threaded C++
    reconstruction, MD5 hashed inline."""
    arr, meta = native_indexer.decode_native_parallel(
        data, check_crc=check_crc, compute_md5=verify_md5)
    si_bps = meta["si_bits_per_sample"]
    _log_stream.debug(
        "decode: %d bytes -> %d frames, engine=native (per-frame trace:"
        " ZFLAC_TPU_LOG reaches the C++ engine too)", len(data),
        meta["frames"])
    if verify_md5:
        if meta["computed_md5"] is not None:
            if meta["computed_md5"] != meta["md5"]:
                raise InvalidChecksum("stream MD5 mismatch")
        elif not verify_stream_md5(arr, si_bps, meta["md5"]):
            raise InvalidChecksum("stream MD5 mismatch")
    shift = fmt.normalization_shift(si_bps)
    if shift:
        # In place: the array owns the engine's buffer.
        if arr.flags.writeable:
            np.left_shift(arr, shift, out=arr)
        else:
            arr = arr << shift
    return DecodedFLAC(
        channels=meta["channels"] or meta.get("si_channels", 1),
        sample_rate=meta["sample_rate"],
        bits_per_sample=meta["bits_per_sample"] or si_bps,
        interleaved=arr,
        stats={"frames": meta["frames"], "engine": "native"},
    )


def decode(data: bytes, check_crc: bool = False, verify_md5: bool = True,
           prefer_native: bool = True, safe_lpc: bool = False,
           engine: str = "torch", *, device="cuda") -> DecodedFLAC:
    """Decode a stream.

    engine:
      "torch"  (the default) host index + reconstruction on `device`
               ("cuda", the default, "cuda:N" or "cpu"): the
               counterpart of the JAX package's "tpu" engine.
      "native" parallel C++ index + threaded C++ reconstruction, all on
               the host; only an explicit request takes it.
    prefer_native: build the torch engine's plan with the C++ indexer
    when it is available (else the Python one).
    safe_lpc: route an int32 stream's LPC subframes through the int64
    accumulator (lpc64), as the JAX package's safe_lpc does.

    The torch engine's `stats` hold the call's host-clock phases
    (utils/timer.py): `plan_ms` (build_plan: `plan_index_ms`,
    `plan_convert_ms` with the C++ indexer, and its `plan_parse_ms`,
    `plan_pack_ms`, `plan_segments` and `plan_fallbacks`),
    `reconstruct_ms`
    (`reconstruct_stage_ms`, `reconstruct_upload_ms`,
    `reconstruct_launch_ms`, `reconstruct_wait_ms`, `assemble_ms`) and
    `finish_ms` (`finish_md5_ms`, `finish_normalize_ms`), and the fixed
    class's counters: `fixed_lanes` (the plan's fixed subframes, run as
    lanes of the lpc kernel) and `fixed_own_launches` (1 where they had
    no lpc class to share a launch with).
    """
    if engine not in ENGINES:
        # A typo'd engine must not fall through to a default path.
        raise ValueError(
            f"unknown engine {engine!r}; expected 'torch' or 'native'")
    if engine == "native":
        return _decode_native(data, check_crc, verify_md5)

    device = resolve_device(device)
    with maybe_trace("zflac_tpu_torch.decode", device), recording() as rec:
        with span("plan"):
            plan = build_plan(data, check_crc=check_crc,
                              prefer_native=prefer_native)
        if safe_lpc and plan.rows.dtype == np.int32:
            plan.wide = (plan.kind == 3)
        if _log_stream.isEnabledFor(10):
            _log_stream.debug(
                "decode: %d bytes sr=%d ch=%d bps=%d frames=%d "
                "subframes=%d", len(data), plan.info.sample_rate,
                plan.info.channel_count, plan.info.bits_per_sample,
                plan.num_frames, plan.num_subframes)
        if _log_frame.isEnabledFor(10) and plan.num_frames:
            for f in range(plan.num_frames):
                _log_frame.debug("frame %d @%d bs=%d ch_code=%d", f,
                                 plan.frame_byte_offset[f],
                                 plan.block_size[f], plan.channel_code[f])
        if plan.num_frames == 0:
            interleaved = np.zeros(0, dtype=container_dtype(
                plan.info.bits_per_sample))
            path = "empty"
        else:
            with span("reconstruct"):
                pcm = _run_reconstruct(plan, device)
                with span("assemble"):
                    interleaved = _assemble(plan, pcm)
            path = "rows"
            _log_kernel.debug("reconstruct path=%s classes=%s", path,
                              {k: len(v) for k, v in plan.classes().items()
                               if len(v)})
        with span("finish"):
            interleaved = _finish(interleaved, plan.info.bits_per_sample,
                                  plan.info.md5, verify_md5)
    stats = dict(plan.stats)
    stats["engine"] = "torch"
    stats["path"] = path
    stats.update(rec.stats)
    return DecodedFLAC(
        channels=plan.channels or plan.info.channel_count,
        sample_rate=plan.sample_rate or plan.info.sample_rate,
        bits_per_sample=plan.bits_per_sample
        or plan.info.bits_per_sample,
        interleaved=interleaved,
        stats=stats,
    )
