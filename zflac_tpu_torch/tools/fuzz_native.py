"""Byte-mutation fuzz of the port's entry surface (counterpart of
tools/fuzz_native.py):

    python3 -m zflac_tpu_torch.tools.fuzz_native [--iters N] [--seed S]
        [--device cuda|cpu] [--check-device cpu]

Every mutated stream must either decode or raise a typed FlacError:
never crash, read out of bounds, trip undefined behaviour, or raise
anything else, a CUDA error or a device-side assert included. Run
under the sanitized scan library (tools/sanitize_run.py) it is the
checked-arithmetic pass of the host code; run on the card it puts
scanner-accepted but corrupt-derived buffers through the kernels.

Entries exercised per mutation:
  decode    decode(engine="native"): the host C++ engine (anchors,
            fused Rice, AVX-512 reconstruction, MD5);
  tolerant  decode_tolerant on `--device` (CRC-validated resync, the
            rows engine's lpc/lpc64 kernels on the card);
  skim      build_plan_skim (the measure-only scan);
  pack2     pack2_range and, when it accepts a chunk, reconstruct_pack2
            of that chunk on `--device` (rice16, the LPC kernel,
            packtail or the general tail), brought to the host.
With `--check-device D`, the two device entries run once more on D
(the CPU: every kernel's plain version) and must agree with the first
run: the same PCM and stats, or the same FlacError class. A kernel
that answers wrongly on a corrupt-derived shape then fails the run
even where it does not crash. With no card it raises unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import decode, decode_tolerant
from .. import format as fmt
from ..bitio import BitReader
from ..encoder import EncoderConfig, encode
from ..errors import FlacError
from ..index.native_indexer import (build_plan_skim, native_available,
                                    pack2_range)
from ..oracle import parse_metadata
from ..runtime import device as rt
from ..testing import correlated_stereo, tone_mix

ENTRIES = ("decode", "tolerant", "skim", "pack2")
# The entries that run on `--device`, and so on `--check-device` too.
DEVICE_ENTRIES = ("tolerant", "pack2")


def streams() -> list:
    return [
        encode(correlated_stereo(20000, 16, seed=1), 44100, 16,
               EncoderConfig(block_size=1024)),
        encode(tone_mix(6000, 2, 24, seed=2), 96000, 24,
               EncoderConfig(block_size=256)),
        encode(tone_mix(4000, 8, 16, seed=3), 48000, 16,
               EncoderConfig(block_size=576)),
        # 3072 = 16 blocks of 192: the forced partition order must
        # divide every block, including the last.
        encode(tone_mix(3072, 1, 8, seed=4), 8000, 8,
               EncoderConfig(block_size=192, partition_order=4)),
        encode(tone_mix(4000, 2, 32, seed=5), 96000, 32,
               EncoderConfig(block_size=512)),
    ]


def mutate(rng, data: bytes) -> bytes:
    buf = bytearray(data)
    mode = rng.integers(0, 4)
    if mode == 0:      # flip 1-4 random bytes
        for _ in range(rng.integers(1, 5)):
            buf[rng.integers(0, len(buf))] ^= int(rng.integers(1, 256))
    elif mode == 1:    # truncate
        del buf[rng.integers(1, len(buf)):]
    elif mode == 2:    # splice a chunk of garbage
        at = rng.integers(0, len(buf))
        n = int(rng.integers(1, 64))
        buf[at:at] = bytes(rng.integers(0, 256, n, dtype=np.uint8))
    else:              # burst-corrupt a window
        at = rng.integers(0, len(buf))
        n = min(int(rng.integers(1, 256)), len(buf) - at)
        buf[at:at + n] = bytes(rng.integers(0, 256, n, dtype=np.uint8))
    return bytes(buf)


def pack2_entry(data: bytes, device):
    """pack2_range, then the accepted chunk reconstructed on `device`.
    Returns the chunk's PCM on the host, or None where the scan
    accepted no chunk."""
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 14, layout="card")
    if ck is None:
        return None
    buf, geom = rt.chunk_to_torch(ck, device)
    return rt.reconstruct_pack2(
        buf, geom,
        container_bits=fmt.container_bits(ck.bits_per_sample)).cpu().numpy()


def tolerant_entry(data: bytes, device):
    r = decode_tolerant(data, device=device)
    return r.interleaved, r.stats


def outcome(fn, data: bytes):
    """(what fn(data) returned, None), or (None, the FlacError's class
    name). Anything but a FlacError propagates."""
    try:
        return fn(data), None
    except FlacError as e:
        return None, type(e).__name__


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def fuzz(iters: int, seed: int, device="cuda", log=print,
         check_device=None) -> dict:
    """Outcome counts over `iters` mutations: "ok" and "typed_error"
    per entry call, "pack2_reconstructed", the mutated streams whose
    pack2 chunk went through reconstruct_pack2, and, with
    `check_device`, "checked", the device entries' outcomes held equal
    to a second run on that device (a difference raises
    AssertionError). Anything but a FlacError propagates."""
    device = rt.resolve_device(device)
    check = None if check_device is None else rt.resolve_device(
        check_device)
    if not native_available():
        raise RuntimeError("the native scan library is unavailable")
    rng = np.random.default_rng(seed)
    base = streams()
    calls = {
        "decode": lambda d, dev: decode(d, engine="native"),
        "tolerant": tolerant_entry,
        "skim": lambda d, dev: build_plan_skim(d),
        "pack2": pack2_entry,
    }
    outcomes = {"ok": 0, "typed_error": 0, "pack2_reconstructed": 0}
    if check is not None:
        outcomes["checked"] = 0
    for i in range(iters):
        data = mutate(rng, base[i % len(base)])
        for entry in ENTRIES:
            fn = calls[entry]
            got, err = outcome(lambda d: fn(d, device), data)
            outcomes["typed_error" if err else "ok"] += 1
            if entry == "pack2" and got is not None:
                outcomes["pack2_reconstructed"] += 1
            if check is not None and entry in DEVICE_ENTRIES:
                want, want_err = outcome(lambda d: fn(d, check), data)
                if err != want_err or not same(got, want):
                    raise AssertionError(
                        f"fuzz iteration {i}, {entry}: {device} gave "
                        f"{err or 'a result'}, {check} "
                        f"{want_err or 'a result'}"
                        + ("" if err or want_err else " that differs"))
                outcomes["checked"] += 1
        if (i + 1) % 50 == 0:
            log(f"[fuzz] {i + 1}/{iters} {outcomes}")
    log(f"[fuzz] done: {outcomes}")
    return outcomes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-device", default=None,
                    help="run the device entries again here and hold "
                    "the two runs equal")
    args = ap.parse_args(argv)
    fuzz(args.iters, args.seed, args.device,
         log=lambda m: print(m, flush=True), check_device=args.check_device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
