"""Frame-parallel sharded reconstruction over several devices
(counterpart of zflac_tpu/parallel/shard.py).

FLAC frames are mutually independent once indexed (warm-ups, predictor
state and residuals are all in-frame), so the frame axis shards
cleanly: each device reconstructs its contiguous frame shard with the
same engine as the single-device path, and the PCM stays on its device
for assembly.

A "mesh" here is a list of torch devices. The JAX package runs one
traced body on every device under shard_map; here the per-device body
is a plain function called once per device, and every device's uploads
and launches are queued before anything is waited for. Two pieces of
the JAX module therefore have no twin: repack_common stacks the chunks
of a round into one [D, L] array for shard_map, and make_pack2_body
builds the one traced body. What is kept of them is the check that all
chunks of a call share one geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..bitio import BitReader
from ..index import native_indexer
from ..oracle import parse_metadata
from ..plan import StreamPlan
from ..runtime.decode import _pad_pow2
from ..runtime.device import (_bucket_block, assemble_chunks, cut_at_total,
                              estimate_total_frames, reconstruct_chunks,
                              resolve_device, stream_chunks, upload)
from ..runtime.reconstruct import reconstruct_core
from ..utils.log import get_logger

_log_shard = get_logger("shard")

# shard_plan's arrays, and the class each idx_* list belongs to.
_SHARD_ARRAYS = ("rows", "kind", "order", "wasted", "shift", "coeffs",
                 "seeds", "channel_code")
_SHARD_CLASSES = {"idx_const": "const", "idx_verb": "verbatim",
                  "idx_fixed": "fixed", "idx_lpc": "lpc",
                  "idx_lpc_wide": "lpc_wide"}


def make_mesh(devices=None) -> list:
    """The devices a sharded decode runs on: every visible CUDA device,
    or the given list ("cuda:0" may repeat; the tests pass "cpu"). A
    CUDA device with no card raises."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def _local_reconstruct(arrays: dict, *, block: int, num_channels: int,
                       container_bits: int):
    """Per-device reconstruction body: one device's slice of
    shard_plan's arrays (tensors on that device) through the rows
    engine's core. Classes with no member on this device are dropped;
    the others keep their sentinel-padded lists, which the core's
    clamped gathers and sentinel-safe scatters take. Stereo frames
    decorrelate by their channel code. Returns (PCM [F_loc, block, C]
    in the container dtype, the first `block` time rows, and the
    samples per channel it holds)."""
    class_idx = {cls: arrays[name] for name, cls in _SHARD_CLASSES.items()
                 if name in arrays}
    pcm = reconstruct_core(
        *(arrays[n] for n in _SHARD_ARRAYS[:7]), class_idx,
        arrays["channel_code"], num_channels=num_channels,
        container_bits=container_bits, do_decorrelate=True)
    return pcm[:, :block], pcm.shape[0] * block


def shard_plan(plan: StreamPlan, num_devices: int):
    """Pad + split plan arrays into [n_dev, ...] leading-axis chunks with
    uniform per-device class index lists. Returns (arrays dict, meta)."""
    C = plan.channels
    F = plan.num_frames
    B = max(plan.max_block, 8)
    F_loc = max(1, -(-F // num_devices))
    Fp = F_loc * num_devices
    Sp = Fp * C
    S_loc = F_loc * C

    dtype = plan.rows.dtype
    rows = np.zeros((Sp, B), dtype=dtype)
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
        width = _pad_pow2(max((len(a) for a in locals_), default=1))
        arr = np.full((num_devices, width), S_loc, dtype=np.int32)
        for d, a in enumerate(locals_):
            arr[d, :len(a)] = a
        class_idx[name] = arr

    arrays = dict(
        rows=rows.reshape(num_devices, S_loc, B),
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


def local_arrays(arrays: dict, meta: dict, d: int, device) -> dict:
    """Device d's slice of shard_plan's arrays on `device` (one upload
    an array). A class with no member on this device is left out. The
    lpc kernels take a time axis of whole groups of 8, so the rows get
    zero columns up to one: they change nothing before them."""
    S_loc = meta["F_loc"] * meta["C"]
    local = {name: a[d] for name, a in arrays.items()
             if name not in _SHARD_CLASSES or (a[d] < S_loc).any()}
    local["rows"] = np.pad(local["rows"], ((0, 0), (0, -meta["B"] % 8)))
    return {name: upload(a, device) for name, a in local.items()}


def reconstruct_sharded(plan: StreamPlan, mesh):
    """Decode-phase-2 across the mesh: slice d of shard_plan's arrays
    goes to mesh[d] and is reconstructed there; every device is queued
    before the first is waited for. Returns host PCM [F, B, C] and the
    total of the per-device sample counts."""
    mesh = make_mesh(mesh)
    arrays, meta = shard_plan(plan, len(mesh))
    container_bits = fmt.container_bits(plan.info.bits_per_sample)
    launched = [_local_reconstruct(
        local_arrays(arrays, meta, d, device), block=meta["B"],
        num_channels=meta["C"], container_bits=container_bits)
        for d, device in enumerate(mesh)]
    pcm = np.concatenate([p.cpu().numpy() for p, _ in launched])
    return pcm[:meta["F"]], sum(n for _, n in launched)


# ---------------------------------------------------------------------------
# pack2 sharded decode: one packed chunk per device and round
# ---------------------------------------------------------------------------

def require_one_geometry(cks) -> tuple:
    """The spec_key every chunk of `cks` shares. Raises ValueError when
    they diverge: the chunks of one call are scanned with one forced
    geometry, so every device runs the same shapes."""
    spec = cks[0].spec_key()
    for ck in cks[1:]:
        if ck.spec_key() != spec:
            raise ValueError("pack2 chunk specs diverge")
    return spec


def chunk_samples(buf, geom):
    """The samples a chunk's buffer says it holds (block size summed
    over its sorted subframes, so samples x channels), as a scalar on
    the buffer's device: the completeness count."""
    return geom.sect(buf, "bssub", geom.Ssort).sum()


def decode_to_device_sharded(data: bytes, mesh, check_crc: bool = False,
                             chunk_frames: int = 0):
    """Frame-parallel device-resident decode over a list of devices
    through the pack2 path: the stream is scanned into packed chunks of
    one geometry, chunk i goes to mesh[i % D] in round i // D (one
    pinned upload and one reconstruct_pack2 there), and nothing is
    waited for. No data crosses devices: frames are independent; the
    per-chunk sample counts are summed on mesh[0] as the completeness
    check. Unknown or wrong STREAMINFO totals are handled by the
    probe-scan frame estimate, not trusted metadata.

    Returns (pcm_rounds, meta): pcm_rounds is a list of rounds, each a
    list of D tensors [Fp, Bp, C], tensor d on mesh[d] (a slot of the
    last round with no chunk holds zeros); meta has the JAX function's
    keys. None when the fast path declines; a CUDA device of the mesh
    with no card raises."""
    mesh = make_mesh(mesh)
    if not native_indexer.native_available():
        return None
    br = BitReader(data)
    info = parse_metadata(br)
    if info.bits_per_sample > 32:
        return None
    pos = br.pos // 8
    D = len(mesh)
    Bp = _bucket_block(max(info.max_block_size, 16))
    if chunk_frames <= 0:
        est_frames = estimate_total_frames(data, pos, info,
                                           check_crc=check_crc)
        if est_frames is None:
            return None
        chunk_frames = _pad_pow2(max(1, -(-est_frames // D)))
        # Per-device memory cap (~64 MiB of padded rows per chunk):
        # longer streams dispatch several rounds instead of one
        # oversized chunk per device.
        while chunk_frames > 1 and \
                chunk_frames * info.channel_count * Bp >= (1 << 25):
            chunk_frames //= 2

    # The parallel scan, the union re-scan and its landed check, the
    # per-chunk loop with its stream-consistency rules and the stop cut
    # are decode_to_device's.
    cks = stream_chunks(data, info, pos, check_crc=check_crc,
                        chunk_frames=chunk_frames)
    if not cks:
        return None
    require_one_geometry(cks)
    n_rounds = -(-len(cks) // D)
    _log_shard.debug(
        "pack2 sharded: %d chunks over %d devices in %d rounds, "
        "%s frames/chunk, Bp=%d", len(cks), D, n_rounds,
        [ck.F for ck in cks], Bp)

    total = torch.zeros((), dtype=torch.int64, device=mesh[0])

    def count(buf, geom):
        total.add_(chunk_samples(buf, geom).to(mesh[0], non_blocking=True))

    pcms = reconstruct_chunks(cks, mesh, each=count)
    # The last round's free slots hold zeros.
    pcms += [torch.zeros_like(pcms[0], device=mesh[d])
             for d in range(len(cks) % D or D, D)]

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
    is the list of rounds, each a list of D tensors [Fp, Bp, C] (one
    such list is accepted as one round); chunk i lives at round i // D,
    slot i % D."""
    rounds = [pcm] if pcm and isinstance(pcm[0], torch.Tensor) else pcm

    def host(i, F):
        D = len(rounds[0])
        return rounds[i // D][i % D][:F].cpu().numpy()

    return assemble_chunks(
        ((host(i, F), F, bs) for i, (F, bs) in
         enumerate(zip(meta["num_frames"], meta["block_sizes"])) if F),
        meta["bits_per_sample"])
