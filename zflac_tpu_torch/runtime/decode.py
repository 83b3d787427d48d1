"""The rows engine's decode entry points in PyTorch (counterpart of
zflac_tpu/runtime/decode.py): bytes -> host index -> device
reconstruction -> assembly -> MD5 -> DecodedFLAC.

The host indexer (index.build_plan, or index_range for a byte range;
the port's copy of the JAX package's) builds a StreamPlan.
_run_reconstruct pads it to the JAX package's bucketed shapes and
sentinel-padded class lists, uploads it (one pinned, non-blocking copy
of one packed buffer for int32 streams; one such copy per array for
int64 streams), reconstructs [F, B, C] PCM on the device
(runtime/reconstruct.py: the lpc kernel at int32, lpc64 at int64) and
copies it back for assembly on the host.

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
from .device import (estimate_total_frames, resolve_device, upload,
                     verify_stream_md5)
from .pack import Packer
from .reconstruct import reconstruct, reconstruct_packed

ENGINES = ("torch", "native")
_PLAN_ARRAYS = ("rows", "kind", "order", "wasted", "shift", "coeffs",
                "seeds", "channel_code")


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _bucket_block(b: int) -> int:
    """Pad the sample axis to a multiple of 128 (the JAX package's
    buckets, so both packages see the same shapes)."""
    return max(128, -(-b // 128) * 128)


def pad_plan(plan: StreamPlan):
    """The plan's arrays padded as the JAX package's _run_reconstruct
    pads them: rows [Sp, Bp] with Bp = _bucket_block(B), Fp = pow2 >= F
    and Sp = Fp * C; per-subframe arrays to Sp; channel_code to Fp; and
    each nonempty class's gather list to a power of two, padded with the
    sentinel Sp. The JAX package also pads the lpc class to 128 entries
    for its lane-blocked Pallas kernel on a TPU; the CUDA kernel takes
    any count, so it pads as the JAX scan path does. Returns (arrays:
    name -> numpy, class_idx: name -> int32 numpy)."""
    F = plan.num_frames
    C = plan.channels
    S = plan.num_subframes
    B = plan.max_block
    Bp = _bucket_block(B)
    Fp = _pad_pow2(F)
    Sp = Fp * C

    rows = np.zeros((Sp, Bp), dtype=plan.rows.dtype)
    rows[:S, :B] = plan.rows

    def pad1(a, n):
        out = np.zeros(n, dtype=a.dtype)
        out[:len(a)] = a
        return out

    coeffs = np.zeros((Sp, 32), dtype=np.int32)
    coeffs[:S] = plan.coeffs_rev
    seeds = np.zeros((Sp, 4), dtype=plan.fixed_seeds.dtype)
    seeds[:S] = plan.fixed_seeds
    arrays = dict(rows=rows, kind=pad1(plan.kind, Sp),
                  order=pad1(plan.order, Sp), wasted=pad1(plan.wasted, Sp),
                  shift=pad1(plan.shift, Sp), coeffs=coeffs, seeds=seeds,
                  channel_code=pad1(plan.channel_code, Fp))
    class_idx = {}
    for name, idx in plan.classes().items():
        if len(idx) == 0:
            continue
        padded = np.full(_pad_pow2(len(idx)), Sp, dtype=np.int32)
        padded[:len(idx)] = idx
        class_idx[name] = padded
    return arrays, class_idx


def plan_to_torch(arrays: dict, class_idx: dict, device):
    """pad_plan's numpy arrays as tensors on `device` (one pinned,
    non-blocking copy each for a CUDA device). Returns (arrays,
    class_idx) with the same keys."""
    return ({k: upload(v, device) for k, v in arrays.items()},
            {k: upload(v, device) for k, v in class_idx.items()})


@dataclass
class StagedPlan:
    """A plan padded on the host, ready for the device: for an int32
    stream one packed int32 buffer (`buf`, `spec`, `class_names`),
    else pad_plan's `arrays` and `class_idx`; `kw` are reconstruct's
    static arguments and F the frame count."""
    F: int
    kw: dict
    buf: np.ndarray | None = None
    spec: tuple = ()
    class_names: tuple = ()
    arrays: dict | None = None
    class_idx: dict | None = None


def stage_plan(plan: StreamPlan) -> StagedPlan:
    """The host half of _run_reconstruct: pad the plan, and pack it
    into one buffer when its rows are int32."""
    arrays, class_idx = pad_plan(plan)
    kw = dict(
        num_channels=plan.channels,
        container_bits=fmt.container_bits(plan.info.bits_per_sample),
        do_decorrelate=bool(
            np.any(plan.channel_code > fmt.CH_INDEPENDENT_MAX)))
    if arrays["rows"].dtype != np.int32:
        return StagedPlan(plan.num_frames, kw, arrays=arrays,
                          class_idx=class_idx)
    p = Packer()
    for name in _PLAN_ARRAYS:
        p.add(name, arrays[name])
    for name, idx in class_idx.items():
        p.add("ci_" + name, idx)
    buf, spec = p.finish()
    return StagedPlan(plan.num_frames, kw, buf=buf, spec=spec,
                      class_names=tuple(sorted(class_idx)))


def launch_plan(staged: StagedPlan, device):
    """The device half: upload the staged plan to `device` (one copy of
    the packed buffer, else one per array) and queue its
    reconstruction. Returns the PCM tensor [Fp, Bp, C] without waiting
    for it."""
    if staged.buf is not None:
        return reconstruct_packed(upload(staged.buf, device),
                                  spec=staged.spec,
                                  class_names=staged.class_names,
                                  **staged.kw)
    t, ci = plan_to_torch(staged.arrays, staged.class_idx, device)
    return reconstruct(*(t[n] for n in _PLAN_ARRAYS[:7]), ci,
                       t["channel_code"], **staged.kw)


def _run_reconstruct(plan: StreamPlan, device, async_: bool = False):
    """Pad the plan, upload it to `device` and reconstruct it there.
    Returns host PCM [F, B, C] (container dtype), or (device tensor
    [Fp, Bp, C], F) when async_ (launched, not waited for)."""
    pcm = launch_plan(stage_plan(plan), device)
    if async_:
        return pcm, plan.num_frames
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
    """The MD5 check (raises InvalidChecksum), then normalize."""
    if verify_md5 and not verify_stream_md5(out, bps, md5):
        raise InvalidChecksum("stream MD5 mismatch")
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
    """
    if engine not in ENGINES:
        # A typo'd engine must not fall through to a default path.
        raise ValueError(
            f"unknown engine {engine!r}; expected 'torch' or 'native'")
    if engine == "native":
        return _decode_native(data, check_crc, verify_md5)

    device = resolve_device(device)
    plan = build_plan(data, check_crc=check_crc,
                      prefer_native=prefer_native)
    if safe_lpc and plan.rows.dtype == np.int32:
        plan.wide = (plan.kind == 3)
    if plan.num_frames == 0:
        interleaved = np.zeros(0, dtype=container_dtype(
            plan.info.bits_per_sample))
        path = "empty"
    else:
        from ..utils.profiler import maybe_trace
        with maybe_trace("zflac_tpu_torch.decode", device):
            interleaved = _assemble(plan, _run_reconstruct(plan, device))
        path = "rows"
    interleaved = _finish(interleaved, plan.info.bits_per_sample,
                          plan.info.md5, verify_md5)
    stats = dict(plan.stats)
    stats["engine"] = "torch"
    stats["path"] = path
    return DecodedFLAC(
        channels=plan.channels or plan.info.channel_count,
        sample_rate=plan.sample_rate or plan.info.sample_rate,
        bits_per_sample=plan.bits_per_sample
        or plan.info.bits_per_sample,
        interleaved=interleaved,
        stats=stats,
    )
