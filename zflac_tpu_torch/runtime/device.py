"""Device-resident decode, pack2 path, in PyTorch (counterpart of
zflac_tpu/runtime/device.py).

`decode_to_device` turns compressed FLAC bytes into PCM in device
memory. Phase 1 is the host C++ scan (`pack2_range`,
index/native_indexer.py, the port's copy of the JAX package's): it
walks the serial bitstream once and writes one int32 plan buffer per
chunk. Phase 2 uploads that buffer with one pinned, stream-ordered
host-to-device copy and reconstructs the chunk on the device:

  rice16 kernel -> patch scatter, warm-up splice, live mask ->
  per class: const broadcast | verbatim | fixed cumsums | LPC kernel
  -> stack + transpose -> tail -> [Fp, Bp, C] PCM.

The LPC kernel is lpc2 in the 8/16-bit containers, lpc2w (64-bit
accumulator) in the 32-bit container and lpc2w33 on wide chunks, whose
33-bit side channels make every value of the chunk int64. The tail is
the packtail kernel for stereo in the 8/16-bit containers, else plain
ops: row gather, wasted-bits shift, decorrelation, transpose and a
wrapping cast to the container dtype. The kernels are hand-written
CUDA (csrc/); the ops between them are plain tensor ops, as XLA runs
them in the JAX package. On CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

Every stream the JAX package's decode_to_device takes is covered: 1-8
channels, containers 8, 16 and 32, and 33-bit side channels.

This module imports neither JAX nor the JAX package: the host pieces
of the JAX package's runtime (chunk scan, frame estimate, class caps,
MD5 check, stop cut) are copied here, and the host modules it builds
on (format, bitio, errors, index, oracle, result) are the port's own
copies of the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import format as fmt
from ..bitio import BitReader
from ..errors import InconsistentParameters, InvalidChecksum
from ..index import native_indexer
from ..oracle import parse_metadata
from ..ops.lpc2 import lpc2_reconstruct
from ..ops.lpc2w import lpc2w33_reconstruct, lpc2w_reconstruct
from ..ops.packtail import packtail
from ..ops.rice16 import rice16_unpack_rows
from ..result import DecodedFLAC, container_dtype
from .reconstruct import decorrelate2, fixed_integrate_t
from .wide import join_i64, wrap_to

_HIST = {"lpc8": 8, "lpc16": 16, "lpc32": 32}
LPC_KERNELS = {"lpc2": lpc2_reconstruct, "lpc2w": lpc2w_reconstruct,
               "lpc2w33": lpc2w33_reconstruct}
_CONTAINER = {8: torch.int8, 16: torch.int16, 32: torch.int32}


@dataclass(frozen=True)
class Pack2Geom:
    """Plain-int geometry of one pack2 chunk buffer: the fields of
    Pack2Chunk.spec_key(), with the section offsets as a dict."""
    Fp: int
    Sp: int
    Bp: int
    GPB: int
    W: int
    NGp: int
    n_patch_p: int
    C: int
    classes: tuple          # ((class name, padded member count), ...)
    off: dict               # section name -> int32 word offset

    @classmethod
    def of(cls, ck) -> "Pack2Geom":
        (Fp, Sp, Bp, GPB, W, NGp, n_patch_p, C, classes,
         off_items) = ck.spec_key()
        return cls(Fp, Sp, Bp, GPB, W, NGp, n_patch_p, C, classes,
                   dict(off_items))

    @property
    def Ssort(self) -> int:
        return sum(np_ for _, np_ in self.classes)

    @property
    def wide(self) -> bool:
        """A chunk with 33-bit side channels: its values are int64."""
        return "warm_hi" in self.off

    def sect(self, buf, name: str, n: int):
        """View of section `name`'s first n words of the buffer."""
        return buf.narrow(0, self.off[name], n)


def resolve_device(device) -> torch.device:
    """`device` ("cuda", "cuda:N" or "cpu") as a torch.device with its
    CUDA index filled in. A CUDA device with no card raises: nothing
    moves to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               "not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def upload(host: np.ndarray, device):
    """A copy of numpy array `host` on `device`. For a CUDA device the
    copy goes through pinned memory, non-blocking on the current
    stream, so it orders before the kernels launched after it."""
    device = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def chunk_to_torch(ck, device):
    """Upload a Pack2Chunk's device buffer (one pinned, non-blocking
    copy for a CUDA device): returns (int32 tensor on `device`,
    Pack2Geom)."""
    return upload(ck.device_buf, device), Pack2Geom.of(ck)


def _patch_rows_layout(out, pidx, pval):
    """Scatter the scan's patch values into the rice16 output
    [(GPB+1)*G2, Ssort] in place (flat index = time * Ssort + lane).
    Pad entries repeat the sentinel, the first element of the dead
    row, so duplicate writes land where nothing reads; the clamp keeps
    a corrupt buffer's indices inside the array."""
    flat = out.view(-1)
    idx = torch.clamp(pidx, 0, flat.numel() - 1).long()
    flat.index_put_((idx,), pval)
    return out


def residual_rows(buf, geom: Pack2Geom):
    """Stage 1 of reconstruct_pack2: the time-major rows [Bp, Ssort]
    (warm-ups spliced in, residuals after, zero past each subframe's
    block size) from the rice16 kernel and the scan's patches; int32,
    or int64 on a wide chunk. The JAX package's stage="rows" (its wide
    path keeps these rows as (hi, lo) pairs)."""
    Bp, W, NGp, Ssort = geom.Bp, geom.W, geom.NGp, geom.Ssort
    sect = geom.sect
    win = sect(buf, "win", W * NGp).view(W, NGp)
    meta = sect(buf, "meta", NGp)
    warm_t = sect(buf, "warm", Ssort * 32).view(32, Ssort)
    warmlen = sect(buf, "warmlen", Ssort)
    bssub = sect(buf, "bssub", Ssort)
    pidx = sect(buf, "pidx", geom.n_patch_p)
    pval = sect(buf, "pval", geom.n_patch_p)

    # Patches never target the warm region (every patch position is
    # >= order), so the splice comes after them. warmlen is 1 (const)
    # or the order (<= 32), so the splice touches the first 32 rows.
    out = rice16_unpack_rows(win, meta, Ssort=Ssort)
    if geom.wide:
        # The rice16 residuals are int32-exact; warm-ups and patches
        # (verbatim samples) may have 33 bits.
        out = out.long()
        pval = join_i64(sect(buf, "pval_hi", geom.n_patch_p), pval)
        warm_t = join_i64(
            sect(buf, "warm_hi", Ssort * 32).view(32, Ssort), warm_t)
    _patch_rows_layout(out, pidx, pval)
    rows_t = out[:Bp]
    row = torch.arange(Bp, device=buf.device)[:, None]
    rows_t[:32] = torch.where(row[:32] < warmlen[None, :], warm_t,
                              rows_t[:32])
    rows_t.masked_fill_(row >= bssub[None, :], 0)
    return rows_t


def _class_slices(geom: Pack2Geom):
    """(class name, its static lane slice of the sorted subframes)."""
    base = 0
    for name, np_ in geom.classes:
        yield name, slice(base, base + np_)
        base += np_


def lpc_kernel(geom: Pack2Geom, container_bits: int) -> str:
    """The LPC kernel of the chunk's LPC classes (a LPC_KERNELS key):
    lpc2w33 on a wide chunk, lpc2w in the 32-bit container (the
    reference's 64-bit accumulator for 17-32 bps), else lpc2."""
    if geom.wide:
        return "lpc2w33"
    return "lpc2w" if container_bits == 32 else "lpc2"


def lpc_class_inputs(rows_t, buf, geom: Pack2Geom) -> dict:
    """The LPC kernel's arguments for each LPC class of the chunk:
    class name -> (rows [Bp, n], cfwd [hist, n], shift [n], order [n])
    over the class's lane slice."""
    Ssort = geom.Ssort
    order = geom.sect(buf, "order", Ssort)
    shift = geom.sect(buf, "shift", Ssort)
    cfwd_t = geom.sect(buf, "cfwd", Ssort * 32).view(32, Ssort)
    return {name: (rows_t[:, sl], cfwd_t[:_HIST[name], sl], shift[sl],
                   order[sl])
            for name, sl in _class_slices(geom) if name in _HIST}


def sorted_stack(rows_t, buf, geom: Pack2Geom, *, container_bits: int):
    """Stage 2 of reconstruct_pack2: every class reconstructed on its
    static lane slice (const broadcast, verbatim, fixed cumsums, the
    LPC kernel of lpc_kernel), stacked with one dead zero lane (the
    `inv` sentinel for padded stream slots) and transposed to
    [Ssort + 1, Bp] for the per-frame row gather, in the rows' dtype.
    The JAX package's stage="transpose"."""
    Bp, Ssort = geom.Bp, geom.Ssort
    order = geom.sect(buf, "order", Ssort)
    seeds_t = geom.sect(buf, "seeds", Ssort * 4).view(4, Ssort)
    if geom.wide:
        seeds_t = join_i64(
            geom.sect(buf, "seeds_hi", Ssort * 4).view(4, Ssort), seeds_t)
    lpc = lpc_class_inputs(rows_t, buf, geom)
    lpc_fn = LPC_KERNELS[lpc_kernel(geom, container_bits)]
    seg_out = []
    for name, sl in _class_slices(geom):
        rc = rows_t[:, sl]                        # [Bp, n] time-major
        if name == "const":
            seg_out.append(rc[0:1].expand(Bp, rc.shape[1]))
        elif name == "verbatim":
            seg_out.append(rc)
        elif name == "fixed":
            seg_out.append(fixed_integrate_t(rc, order[sl], seeds_t[:, sl]))
        else:
            seg_out.append(lpc_fn(*lpc[name]))
    seg_out.append(torch.zeros((Bp, 1), dtype=rows_t.dtype,
                               device=buf.device))
    return torch.cat(seg_out, dim=1).t().contiguous()


def tail_inputs(buf, geom: Pack2Geom):
    """The tail's per-frame sections: (inv, wasted, chcode)."""
    return (geom.sect(buf, "inv", geom.Sp),
            geom.sect(buf, "wasted", geom.Sp),
            geom.sect(buf, "chcode", geom.Fp))


def general_tail(stack, buf, geom: Pack2Geom, *, container_bits: int):
    """Stage 3 for every chunk but stereo in an 8/16-bit container:
    the stack's rows gathered into stream order by `inv`, shifted left
    by their wasted bits, reshaped to [Fp, C, Bp], decorrelated when
    C == 2, transposed to [Fp, Bp, C] and cast to the container dtype
    with wraparound. On a wide chunk this runs in int64 and keeps the
    low words (zflac_tpu/runtime/device.py:286-303 and
    _reconstruct_pack2_wide33 :393-408)."""
    Fp, C, Bp = geom.Fp, geom.C, geom.Bp
    if geom.wide and C != 2:
        raise ValueError(f"wide chunk with {C} channels: 33-bit side "
                         "channels exist only in stereo")
    inv, wasted, chcode = tail_inputs(buf, geom)
    # The clamp keeps a corrupt buffer's indices inside the stack, as
    # XLA's gather clamps them.
    inv = torch.clamp(inv, 0, stack.shape[0] - 1).long()
    frames = (stack[inv] << wasted[:, None]).view(Fp, C, Bp)
    if C == 2:
        frames = torch.stack(decorrelate2(frames[:, 0], frames[:, 1],
                                          chcode[:, None]), dim=1)
    pcm = frames.transpose(1, 2).contiguous()
    return wrap_to(pcm, _CONTAINER[container_bits])


def reconstruct_pack2(buf, geom: Pack2Geom, *, container_bits: int):
    """One uploaded pack2 chunk -> container-width PCM [Fp, Bp, C] on
    the buffer's device. Counterpart of the JAX package's
    _reconstruct_pack2_core and _reconstruct_pack2_wide33."""
    rows_t = residual_rows(buf, geom)
    stack = sorted_stack(rows_t, buf, geom, container_bits=container_bits)
    if geom.C != 2 or container_bits not in (8, 16):
        return general_tail(stack, buf, geom,
                            container_bits=container_bits)
    packed = packtail(stack, *tail_inputs(buf, geom), Fp=geom.Fp,
                      container_bits=container_bits)
    return packed.view(_CONTAINER[container_bits]).view(geom.Fp, geom.Bp, 2)


@dataclass
class DeviceDecoded:
    """Device-resident decode result: per-chunk PCM tensors.

    chunks[i] is [Fp, Bp, C] in the container dtype; frame f of chunk i
    holds block_sizes[i][f] valid samples. Values are pre-normalization
    (the MD5 domain); the normalization shift applies on export."""
    channels: int
    sample_rate: int
    bits_per_sample: int
    total_samples: int
    device: torch.device
    chunks: list = field(default_factory=list)
    num_frames: list = field(default_factory=list)
    block_sizes: list = field(default_factory=list)
    md5: bytes = b""
    stats: dict = field(default_factory=dict)

    def synchronize(self):
        """Wait until every chunk's reconstruction has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def interleaved_device(self, normalized: bool = True):
        """The decoded stream as one device tensor [total_samples, C]
        (container dtype). Constant-blocksize chunks assemble by slices
        and one concatenation; variable blocking gathers frame rows by
        an index. `normalized` applies the container-MSB shift
        (zflac.zig:287-306); False keeps the MD5 domain."""
        C = self.channels
        parts = []
        for pcm, F, bs in zip(self.chunks, self.num_frames,
                              self.block_sizes):
            if F == 0:
                continue
            if np.all(bs == bs[0]):
                n = int(bs.sum())
                parts.append(pcm[:F, :int(bs[0]), :].reshape(-1, C)[:n])
            else:
                Bp = pcm.shape[1]
                idx = np.concatenate(
                    [f * Bp + np.arange(b) for f, b in enumerate(bs)])
                parts.append(pcm.reshape(-1, C)[
                    torch.as_tensor(idx, device=pcm.device)])
        if parts:
            out = torch.cat(parts, dim=0)
        else:
            dtype = getattr(torch, np.dtype(
                container_dtype(self.bits_per_sample)).name)
            out = torch.zeros((0, C), dtype=dtype, device=self.device)
        shift = fmt.normalization_shift(self.bits_per_sample)
        if normalized and shift:
            out = out << shift
        return out

    def to_host(self, verify_md5: bool = True) -> DecodedFLAC:
        """Interleaved host PCM (the reference's output contract),
        with the stream MD5 verified (raises InvalidChecksum) and the
        bit-depth normalization applied (zflac.zig:267-306)."""
        out = assemble_chunks(
            ((pcm[:F].cpu().numpy(), F, bs) for pcm, F, bs in
             zip(self.chunks, self.num_frames, self.block_sizes)),
            self.bits_per_sample)
        if verify_md5 and self.md5:
            if not verify_stream_md5(out, self.bits_per_sample, self.md5):
                raise InvalidChecksum("stream MD5 mismatch")
        shift = fmt.normalization_shift(self.bits_per_sample)
        if shift:
            out = out << shift
        return DecodedFLAC(
            channels=self.channels, sample_rate=self.sample_rate,
            bits_per_sample=self.bits_per_sample, interleaved=out,
            stats=dict(self.stats))


def chunk_parts(p: np.ndarray, F: int, bs) -> list:
    """The valid samples of one chunk's host PCM p [>= F, Bp, C],
    interleaved, as a list of flat arrays: one slice for a constant
    block size, else one per frame."""
    if F and np.all(bs[:F] == bs[0]):
        return [p[:F, :bs[0], :].reshape(-1)]
    return [p[f, :bs[f], :].reshape(-1) for f in range(F)]


def assemble_chunks(chunks, bits_per_sample: int) -> np.ndarray:
    """Interleaved host PCM (pre-normalization domain) of `chunks`, an
    iterable of (host PCM [>= F, Bp, C], F, block sizes); empty in the
    container dtype when they hold no frame."""
    parts = [part for p, F, bs in chunks for part in chunk_parts(p, F, bs)]
    if not parts:
        return np.zeros(0, dtype=container_dtype(bits_per_sample))
    return np.concatenate(parts)


def verify_stream_md5(interleaved: np.ndarray, bps: int,
                      expected: bytes) -> bool:
    """MD5 over the smallest-whole-byte little-endian sample bytes
    (zflac.zig:267-277)."""
    nbytes = fmt.md5_bytes_per_sample(bps)
    if nbytes == 3:
        raw = interleaved.astype("<i4").view(np.uint8).reshape(-1, 4)[
            :, :3].tobytes()
    else:
        raw = interleaved.astype(f"<i{nbytes}", copy=False).tobytes()
    return hashlib.md5(raw).digest() == expected


def _bucket_block(b: int) -> int:
    return max(128, -(-b // 128) * 128)


def estimate_total_frames(data: bytes, pos: int, info,
                          check_crc: bool = False):
    """Frame-count estimate for chunk sizing: from a nonzero
    STREAMINFO total, else a probe scan of the first ~64 frames
    extrapolated by measured bytes/frame. Returns an int >= 1, or None
    when even the probe declines."""
    nominal = max(info.min_block_size, 16)
    if info.total_samples:
        return -(-info.total_samples // nominal)
    probe = native_indexer.pack2_range(data, pos, len(data), info,
                                       check_crc=check_crc, max_frames=64)
    if probe is None or probe.F == 0:
        return None
    if probe.landed >= len(data):
        return probe.F
    bpf = max(1, (probe.landed - pos) // probe.F)
    return max(probe.F, -(-(len(data) - pos) // bpf))


def class_caps(cks):
    """Union class capacities (in PACK2_CLASSES order), patch capacity
    and wide flag over a chunk list: the force_* inputs that make a
    re-scan of each chunk produce one identical geometry."""
    caps = {}
    for ck in cks:
        for name, cn, _ in ck.classes:
            caps[name] = max(caps.get(name, 0), cn)
    cnp = [caps.get(n, 0) for n in native_indexer.PACK2_CLASSES]
    pnp = max([ck.n_patch_p for ck in cks] + [1])
    wide = any(ck.wide for ck in cks)
    return cnp, pnp, wide


def scan_pack2_chunks(data: bytes, pos: int, info, chunk_frames: int,
                      Bp: int, check_crc: bool, workers: int = 0):
    """Scan the stream into pack2 chunks, in parallel across byte
    ranges split at sync-scan anchors (CRC-validated frame starts); the
    ctypes scan releases the GIL, so the C++ scans overlap. The chunk
    chain is verified (each range must start where the previous one
    landed); an anchor miss, a decline inside a range or a chain break
    falls back to one serial scan.

    Returns a list of (start_byte, Pack2Chunk), or None (decline)."""
    def seq(a, stop):
        out = []
        p = a
        force_w = 0
        while p < stop:
            ck = native_indexer.pack2_range(
                data, p, stop, info, check_crc=check_crc,
                max_frames=chunk_frames, force_fp=chunk_frames,
                force_bp=Bp, force_w=force_w)
            if ck is None:
                return None
            if ck.F == 0:
                break
            force_w = ck.W
            out.append((p, ck))
            if ck.landed <= p:
                break
            p = ck.landed
        return out

    auto = workers <= 0
    if auto:
        workers = min(os.cpu_count() or 1, 8)
    span = len(data) - pos
    # Parallelism pays only when several chunk scans fit the span;
    # explicit workers (> 0) force the split path.
    if workers < 2 or (auto and span < (1 << 20)):
        return seq(pos, len(data))
    bounds = [pos + span * k // workers for k in range(workers + 1)]
    anchors = [native_indexer.find_anchor(data, bounds[k], bounds[k + 1],
                                          info)
               for k in range(1, workers)]
    starts = sorted({pos} | {a for a in anchors if a >= 0})
    ranges = [(s, starts[i + 1] if i + 1 < len(starts) else len(data))
              for i, s in enumerate(starts)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(lambda r: seq(*r), ranges))
    if any(p is None for p in parts):
        return seq(pos, len(data))
    out = []
    expect = pos
    for (a, _stop), part in zip(ranges, parts):
        if a != expect:                 # chain break: serial truth
            return seq(pos, len(data))
        out.extend(part)
        if part:
            expect = part[-1][1].landed
    return out


def apply_stop_cut(block_sizes, total: int):
    """Reference stop semantics at the STREAMINFO total
    (zflac.zig:343-350, 394-402): decoding stops at the first frame
    whose START reaches `total`, so whole trailing frames drop; a frame
    that CROSSES the total invalidates it and everything is kept.

    block_sizes: per-chunk frame block sizes. Returns None when nothing
    drops, else (chunk index, frame index, samples kept) of the first
    dropped frame."""
    offset, valid = 0, True
    for ci, bs_arr in enumerate(block_sizes):
        for fi, b in enumerate(bs_arr):
            if valid and offset >= total:
                return ci, fi, offset
            if valid and offset + int(b) > total:
                valid = False
            offset += int(b)
    return None


def cut_at_total(num_frames: list, block_sizes: list, total: int):
    """apply_stop_cut on a decode's per-chunk tables, in place: the
    chunk that holds the first dropped frame keeps its frames before
    it (the block sizes from it on set to 0), and every later chunk
    keeps none. Returns None when nothing drops (no total, or none
    reached), else (that chunk's index, the samples kept)."""
    decoded = sum(int(bs.sum()) for bs in block_sizes)
    if not total or decoded <= total:
        return None
    cut = apply_stop_cut(block_sizes, total)
    if cut is None:
        return None
    ci, fi, kept = cut
    bs = block_sizes[ci].copy()
    bs[fi:] = 0
    block_sizes[ci] = bs
    num_frames[ci] = fi
    for cj in range(ci + 1, len(block_sizes)):
        num_frames[cj] = 0
        block_sizes[cj] = block_sizes[cj][:0]
    return ci, kept


def reconstruct_chunks(cks, devices, each=None) -> list:
    """Chunk i of one stream's pack2 chunks uploaded to
    devices[i % len(devices)] and reconstructed there, every chunk
    queued and none waited for: the list of PCM tensors [Fp, Bp, C].
    `each(buf, geom)`, when given, is called on every chunk's uploaded
    buffer after its reconstruction is queued. Raises
    InconsistentParameters when the stream's parameters change between
    chunks."""
    pcms = []
    for i, ck in enumerate(cks):
        if (ck.sample_rate != cks[0].sample_rate or ck.C != cks[0].C or
                ck.bits_per_sample != cks[0].bits_per_sample):
            raise InconsistentParameters(
                "stream parameters changed mid-stream")
        buf, geom = chunk_to_torch(ck, devices[i % len(devices)])
        pcms.append(reconstruct_pack2(
            buf, geom, container_bits=fmt.container_bits(ck.bits_per_sample)))
        if each is not None:
            each(buf, geom)
    return pcms


def stream_chunks(data: bytes, info, pos: int, *, check_crc: bool = False,
                  chunk_frames: int = 0, scan_workers: int = 0,
                  stats: dict | None = None):
    """The pack2 chunks decode_to_device reconstructs for the stream
    whose frames start at byte `pos`: a parallel scan, then, where the
    chunks' geometries differ, a re-scan of each with their union.
    Returns a list of Pack2Chunk, or None (decline). Fills `stats` with
    the host-clock times of the scan and the re-scan."""
    Bp = _bucket_block(max(info.max_block_size, 16))
    t_scan = time.perf_counter()
    if chunk_frames <= 0:
        # Whole stream in one chunk up to ~64 MiB of padded rows;
        # longer streams go in fixed-size chunks.
        total_frames = estimate_total_frames(data, pos, info,
                                             check_crc=check_crc)
        if total_frames is None:
            return None
        chunk_frames = 1
        while chunk_frames < total_frames and \
                chunk_frames * info.channel_count * Bp < (1 << 24):
            chunk_frames *= 2

    chunks = scan_pack2_chunks(data, pos, info, chunk_frames, Bp,
                               check_crc, workers=scan_workers)
    if not chunks:
        return None
    cks = [ck for _, ck in chunks]
    t_rescan = time.perf_counter()
    # One geometry across all chunks: if any chunk's natural geometry
    # diverges, re-scan each chunk's byte range with the forced union
    # geometry. A re-scan must land where the natural scan did.
    spec0 = cks[0].spec_key()
    if any(ck.spec_key() != spec0 for ck in cks[1:]):
        cnp, pnp, wide_u = class_caps(cks)
        force_w = max(ck.W for ck in cks)
        cks = [native_indexer.pack2_range(
                   data, a, ck.landed, info, check_crc=check_crc,
                   max_frames=chunk_frames, force_fp=chunk_frames,
                   force_bp=Bp, force_w=force_w, force_class_np=cnp,
                   force_patch_np=pnp, force_wide=wide_u)
               for a, ck in chunks]
        if any(ck is None or ck.landed != nat.landed
               for ck, (_, nat) in zip(cks, chunks)):
            return None
    if stats is not None:
        t_end = time.perf_counter()
        stats.update(scan_ms=(t_rescan - t_scan) * 1e3,
                     rescan_ms=(t_end - t_rescan) * 1e3)
    return cks


def decode_to_device(data: bytes, *, device="cuda", check_crc: bool = False,
                     chunk_frames: int = 0, scan_workers: int = 0):
    """Decode a stream to PCM on `device` ("cuda", the default,
    "cuda:N" or "cpu").

    Returns a DeviceDecoded, or None where the JAX package's
    decode_to_device declines (exotic or mismatching streams, no
    native scan library). A CUDA device with no card raises; nothing
    moves to the CPU unless the caller asks for it. The host scan runs
    in parallel (scan_workers=0 picks the core count, up to 8); uploads
    and kernels are queued on the current stream without waiting."""
    device = resolve_device(device)
    if not native_indexer.native_available():
        return None
    br = BitReader(data)
    info = parse_metadata(br)
    if info.bits_per_sample > 32:
        return None
    times = {}
    cks = stream_chunks(data, info, br.pos // 8, check_crc=check_crc,
                        chunk_frames=chunk_frames,
                        scan_workers=scan_workers, stats=times)
    if not cks:
        return None

    t_enqueue = time.perf_counter()
    dd = DeviceDecoded(
        channels=cks[0].C, sample_rate=cks[0].sample_rate,
        bits_per_sample=cks[0].bits_per_sample, total_samples=0,
        device=device, md5=info.md5,
        chunks=reconstruct_chunks(cks, [device]),
        num_frames=[ck.F for ck in cks],
        block_sizes=[ck.f_block_size for ck in cks],
        stats={"engine": "pack2"})
    # Host-clock phase times: the scan (with the frame estimate), the
    # union re-scan, and queueing the uploads and kernels (the device
    # work itself is not waited for).
    t_end = time.perf_counter()
    dd.total_samples = sum(int(bs.sum()) for bs in dd.block_sizes)
    cut = cut_at_total(dd.num_frames, dd.block_sizes, info.total_samples)
    if cut is not None:
        ci, dd.total_samples = cut
        del dd.chunks[ci + 1:]
        del dd.num_frames[ci + 1:]
        del dd.block_sizes[ci + 1:]
    dd.stats.update(frames=sum(dd.num_frames), chunks=len(dd.chunks),
                    **times, enqueue_ms=(t_end - t_enqueue) * 1e3)
    return dd
