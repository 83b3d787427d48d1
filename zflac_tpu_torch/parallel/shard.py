"""Frame-parallel sharded reconstruction over several devices
(counterpart of zflac_tpu/parallel/shard.py).

FLAC frames are mutually independent once indexed (warm-ups, predictor
state and residuals are all in-frame), so the frame axis shards
cleanly: each device reconstructs its contiguous frame shard with the
same engine as the single-device path, and the PCM stays on its device
for assembly.

A "mesh" here is a list of torch devices. The JAX package runs one
traced body on every device under shard_map, so every device holds
one slice of one global array: all slots of a call share one shape.
Here the per-device body is a plain function called once per device,
and every device's uploads and launches are queued before anything is
waited for. So nothing here needs a common shape: each pack2 chunk is
reconstructed in its own card geometry [F_i, Bp, C], and each device's
slice of a rows plan has the kernels' shapes (shard_plan). The JAX module's repack_common, which stacks a round's chunks
into one [D, L] array, and make_pack2_body, the one traced body, have
no twin.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..bitio import BitReader
from ..index import native_indexer
from ..oracle import parse_metadata
from ..plan import StreamPlan
from ..runtime.decode import (CLASS_GROUP, PLAN_ARRAYS, TIME_GROUP,
                              StagedPlan, _round_up, launch_plan,
                              stage_arrays)
from ..runtime.device import (assemble_chunks, cut_at_total,
                              estimate_total_frames, reconstruct_chunks,
                              resolve_device, slot_block, stream_chunks)
from ..utils.log import get_logger

_log_shard = get_logger("shard")

# The class each of shard_plan's idx_* lists belongs to.
_SHARD_CLASSES = {"idx_const": "const", "idx_verb": "verbatim",
                  "idx_fixed": "fixed", "idx_lpc": "lpc",
                  "idx_lpc_wide": "lpc_wide"}


def _pad_pow2(n: int) -> int:
    """The least power of two >= n. Used only in
    decode_to_device_sharded's chunk-size rule, which keeps the JAX
    function's on purpose: it keeps the chunk boundaries, and so the
    result's meta, equal to the JAX function's."""
    p = 1
    while p < n:
        p *= 2
    return p


def make_mesh(devices=None) -> list:
    """The devices a sharded decode runs on: every visible CUDA device,
    or the given list ("cuda:0" may repeat; the tests pass "cpu"). A
    CUDA device with no card raises."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def shard_plan(plan: StreamPlan, num_devices: int):
    """Pad + split plan arrays into [n_dev, ...] leading-axis chunks with
    uniform per-device class index lists. Returns (arrays dict, meta).

    The frames split evenly, F_loc = ceil(F / n_dev) a device, as in
    the JAX function, whose meta this is. The shapes are what the rows
    engine's kernels need (runtime/decode.py pad_plan), not the JAX
    function's: rows [n_dev, S_loc, B8], B8 = B rounded up to
    TIME_GROUP, and every class list padded to its largest device's
    members rounded up to CLASS_GROUP (0 for a class with no member),
    where the JAX function takes B and the next power of two. The
    sentinel is S_loc."""
    C = plan.channels
    F = plan.num_frames
    B = max(plan.max_block, 8)
    F_loc = max(1, -(-F // num_devices))
    Fp = F_loc * num_devices
    Sp = Fp * C
    S_loc = F_loc * C

    dtype = plan.rows.dtype
    width = _round_up(B, TIME_GROUP)
    rows = np.zeros((Sp, width), dtype=dtype)
    rows[:plan.num_subframes, :plan.max_block] = plan.rows

    def pad1(a, n, dt=None):
        out = np.zeros(n, dtype=dt or a.dtype)
        out[:len(a)] = a
        return out

    kind = pad1(plan.kind, Sp)
    order = pad1(plan.order, Sp)
    wasted = pad1(plan.wasted, Sp)
    shift = pad1(plan.shift, Sp)
    coeffs = np.zeros((Sp, 32), np.int32)
    coeffs[:plan.num_subframes] = plan.coeffs_rev
    seeds = np.zeros((Sp, 4), plan.fixed_seeds.dtype)
    seeds[:plan.num_subframes] = plan.fixed_seeds
    channel_code = pad1(plan.channel_code, Fp)
    wide = pad1(plan.wide, Sp, np.bool_)

    # Per-device local class lists, padded to the max size across
    # devices (uniform shapes). Out-of-range sentinel = S_loc.
    kinds_split = kind.reshape(num_devices, S_loc)
    wide_split = wide.reshape(num_devices, S_loc)
    class_defs = {
        "const": lambda k, w: k == 0,
        "verbatim": lambda k, w: k == 1,
        "fixed": lambda k, w: k == 2,
        "lpc": lambda k, w: (k == 3) & ~w,
        "lpc_wide": lambda k, w: (k == 3) & w,
    }
    class_idx = {}
    for name, pred in class_defs.items():
        locals_ = [np.nonzero(pred(kinds_split[d], wide_split[d]))[0]
                   for d in range(num_devices)]
        n = _round_up(max(len(a) for a in locals_), CLASS_GROUP)
        arr = np.full((num_devices, n), S_loc, dtype=np.int32)
        for d, a in enumerate(locals_):
            arr[d, :len(a)] = a
        class_idx[name] = arr

    arrays = dict(
        rows=rows.reshape(num_devices, S_loc, width),
        kind=kinds_split,
        order=order.reshape(num_devices, S_loc),
        wasted=wasted.reshape(num_devices, S_loc),
        shift=shift.reshape(num_devices, S_loc),
        coeffs=coeffs.reshape(num_devices, S_loc, 32),
        seeds=seeds.reshape(num_devices, S_loc, 4),
        idx_const=class_idx["const"],
        idx_verb=class_idx["verbatim"],
        idx_fixed=class_idx["fixed"],
        idx_lpc=class_idx["lpc"],
        idx_lpc_wide=class_idx["lpc_wide"],
        channel_code=channel_code.reshape(num_devices, F_loc),
    )
    meta = dict(F=F, Fp=Fp, F_loc=F_loc, B=B, C=C)
    return arrays, meta


def local_plan(arrays: dict, meta: dict, d: int,
               container_bits: int) -> StagedPlan:
    """Device d's slice of shard_plan's arrays, in the shapes the
    kernels take, staged as the rows engine stages a plan (one packed
    buffer, runtime/decode.py stage_arrays). A class with no member on
    this device is left out; the others keep their sentinel-padded
    lists, which the core's clamped gathers and sentinel-safe scatters
    take. Stereo frames decorrelate by their channel code."""
    S_loc = meta["F_loc"] * meta["C"]
    class_idx = {cls: arrays[name][d]
                 for name, cls in _SHARD_CLASSES.items()
                 if (arrays[name][d] < S_loc).any()}
    return stage_arrays(
        {n: arrays[n][d] for n in PLAN_ARRAYS}, class_idx,
        dict(num_channels=meta["C"], container_bits=container_bits,
             do_decorrelate=True))


def reconstruct_sharded(plan: StreamPlan, mesh):
    """Decode-phase-2 across the mesh: slice d of shard_plan's arrays
    goes to mesh[d] in one upload and is reconstructed there by the
    rows engine's core; every device is queued before the first is
    waited for. Returns host PCM [F, B, C] and the total of the
    per-device sample counts (the JAX function's: F_loc x B a
    device)."""
    mesh = make_mesh(mesh)
    arrays, meta = shard_plan(plan, len(mesh))
    container_bits = fmt.container_bits(plan.info.bits_per_sample)
    B = meta["B"]
    launched = [launch_plan(local_plan(arrays, meta, d, container_bits),
                            device)[:, :B]
                for d, device in enumerate(mesh)]
    pcm = np.concatenate([p.cpu().numpy() for p in launched])
    return pcm[:meta["F"]], sum(p.shape[0] * B for p in launched)


# ---------------------------------------------------------------------------
# pack2 sharded decode: one packed chunk per device and round
# ---------------------------------------------------------------------------

def chunk_samples(buf, geom):
    """The samples a chunk's buffer says it holds (block size summed
    over its sorted subframes, so samples x channels), as a scalar on
    the buffer's device: the completeness count."""
    return geom.sect(buf, "bssub", geom.Ssort).sum()


def sharded_chunk_frames(data: bytes, pos: int, info, num_devices: int,
                         check_crc: bool = False):
    """The JAX function's chunk size for a stream whose frames start at
    byte `pos` over `num_devices` slots: the next power of two of the
    frame estimate over the slots, halved while a chunk in the JAX
    slot shape ([chunk_frames, slot_block, C]) would hold 32 Mi samples
    or more. Chunks are cut at this size so that their boundaries, and
    with them the result's meta, equal the JAX function's; the port's
    chunks are not padded to it. None when the frame estimate
    declines."""
    est_frames = estimate_total_frames(data, pos, info, check_crc=check_crc)
    if est_frames is None:
        return None
    chunk_frames = _pad_pow2(max(1, -(-est_frames // num_devices)))
    # Per-device memory cap (~64 MiB of padded rows per chunk in the
    # JAX function): longer streams dispatch several rounds instead of
    # one oversized chunk per device.
    Bp = slot_block(max(info.max_block_size, 16))
    while chunk_frames > 1 and \
            chunk_frames * info.channel_count * Bp >= (1 << 25):
        chunk_frames //= 2
    return chunk_frames


def decode_to_device_sharded(data: bytes, mesh, check_crc: bool = False,
                             chunk_frames: int = 0):
    """Frame-parallel device-resident decode over a list of devices
    through the pack2 path: the stream is scanned into packed chunks of
    at most `chunk_frames` frames (the JAX function's chunk size when 0,
    sharded_chunk_frames), each in its own card geometry, and chunk i
    goes to mesh[i % D] in round i // D (one pinned upload and one
    reconstruct_pack2 there), and nothing is waited for. No data
    crosses devices: frames are independent; the per-chunk sample
    counts are summed on mesh[0] as the completeness check. Unknown or
    wrong STREAMINFO totals are handled by the probe-scan frame
    estimate, not trusted metadata.

    Returns (pcm_rounds, meta): pcm_rounds is a list of rounds, each a
    list of tensors, tensor d on mesh[d]. Chunk i's tensor is [F_i, Bp,
    C]: F_i its frames, Bp the card layout's (the stream's largest
    block rounded up to 8, at least 16). Every round but the last holds
    D tensors; the last holds the chunks that are left, so it may be
    shorter. meta has the JAX function's keys and values. None when the
    fast path declines; a CUDA device of the mesh with no card
    raises."""
    mesh = make_mesh(mesh)
    if not native_indexer.native_available():
        return None
    br = BitReader(data)
    info = parse_metadata(br)
    if info.bits_per_sample > 32:
        return None
    pos = br.pos // 8
    D = len(mesh)
    if chunk_frames <= 0:
        chunk_frames = sharded_chunk_frames(data, pos, info, D,
                                            check_crc=check_crc)
        if chunk_frames is None:
            return None

    # The parallel scan, the per-chunk loop with its stream-consistency
    # rules and the stop cut are decode_to_device's.
    cks = stream_chunks(data, info, pos, check_crc=check_crc,
                        chunk_frames=chunk_frames)
    if not cks:
        return None
    n_rounds = -(-len(cks) // D)
    _log_shard.debug(
        "pack2 sharded: %d chunks over %d devices in %d rounds, "
        "%s frames/chunk, Bp=%d", len(cks), D, n_rounds,
        [ck.F for ck in cks], cks[0].Bp)

    total = torch.zeros((), dtype=torch.int64, device=mesh[0])

    def count(buf, geom):
        total.add_(chunk_samples(buf, geom).to(mesh[0], non_blocking=True))

    pcms = reconstruct_chunks(cks, mesh, each=count)

    num_frames = [ck.F for ck in cks]
    block_sizes = [ck.f_block_size for ck in cks]
    cut_at_total(num_frames, block_sizes, info.total_samples)
    meta = {
        "channels": cks[0].C,
        "sample_rate": cks[0].sample_rate,
        "bits_per_sample": cks[0].bits_per_sample,
        "num_frames": num_frames,
        "block_sizes": block_sizes,
        "md5": info.md5,
        "psum_samples": total,
        "rounds": n_rounds,
    }
    return [pcms[r * D:(r + 1) * D] for r in range(n_rounds)], meta


def sharded_to_host(pcm, meta):
    """Assemble a sharded pack2 result into interleaved host PCM
    (pre-normalization domain), honoring per-frame block sizes. `pcm`
    is the list of rounds, each a list of tensors [F_i, Bp, C] (one
    such list is accepted as one round); chunk i lives at round i // D,
    slot i % D, with D the first round's length: every round but the
    last is full, and when the first is the only one, i // D is 0 for
    every chunk it holds."""
    rounds = [pcm] if pcm and isinstance(pcm[0], torch.Tensor) else pcm

    def host(i, F):
        D = len(rounds[0])
        return rounds[i // D][i % D][:F].cpu().numpy()

    return assemble_chunks(
        ((host(i, F), F, bs) for i, (F, bs) in
         enumerate(zip(meta["num_frames"], meta["block_sizes"])) if F),
        meta["bits_per_sample"])
