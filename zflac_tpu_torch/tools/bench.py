"""End-to-end decode throughput of the port against the single-threaded
native CPU baseline, plus the device throughput of the pack2 path
(counterpart of bench.py). Run on the machine with the card:

    python3 -m zflac_tpu_torch.tools.bench [--samples N] [--reps N]
        [--device cuda|cpu]

The stream is bench16 (tools/streams.py: 2**22 stereo samples a
channel, 16 bits, block 4096). One decode(data) with the stream MD5
verified warms up (it raises on a mismatch), its frame count is held
to the native scalar decoder's, and `md5_verified` is the MD5 of its
samples, hashed again here, against the stream's STREAMINFO MD5. Then the port's default decode(data) (the torch engine on
the device) and the baseline, decode_cpu_native with the stream MD5
checked as the reference's decode does (BASELINE.md), are timed in A-B-A
blocks, best of `--reps` each (BENCH_REPS, default 9; the minimum is
the host's capability on a noisy shared machine, applied to both).
`gpu_chip_msps` and `gpu_chip_msps_24` are reconstruct_pack2's
throughput on bench16's and bench24's whole-stream chunk (card layout)
resident on the device, from tools/bench_kernels.py (the median of `--reps` CUDA
graph replays).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"engine", "engine_wall_ms", "baseline_wall_ms", "bench_samples",
"frames", "md5_verified", "gpu_chip_msps", "gpu_chip_msps_24",
"device", "timer"}, and the
card's `nvidia-smi` line on stderr. With no card it raises; `--device
cpu` decodes and times on the CPU (the CPU tests), and "timer" then
says that the chip numbers are host-clock CPU numbers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import decode
from ..index.native_indexer import decode_cpu_native
from ..runtime.device import resolve_device, verify_stream_md5
from ..utils.cudatime import gpu_line
from . import bench_kernels, streams

REPS = 9


def best_times_aba(fn_a, fn_b, reps: int = REPS) -> tuple:
    """Best-of-N for two functions in A-B-A blocks: each side's minimum
    comes from consecutive (cache-warm) runs, while the split A block
    straddles B in time so slow drift in host load hits both sides."""
    ta, tb = [], []
    first = (reps + 1) // 2
    for fn, out, n in ((fn_a, ta, first), (fn_b, tb, reps),
                       (fn_a, ta, reps - first)):
        for _ in range(n):
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
    return float(np.min(ta)), float(np.min(tb))


def baseline(data: bytes):
    """The scalar native decode with the stream MD5 checked."""
    arr, meta = decode_cpu_native(data)
    if hashlib.md5(arr.tobytes()).digest() != meta["md5"]:
        raise AssertionError("baseline: stream MD5 mismatch")
    return arr, meta


def run(samples: int, device, reps: int = REPS) -> dict:
    device = resolve_device(device)
    data = streams.bench_stream("bench16", samples)

    def engine():
        out = decode(data, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    r = engine()   # warm-up: kernels built and loaded, MD5 verified
    total = r.num_samples * r.channels
    _, meta = baseline(data)
    # 16-bit samples carry no normalization shift: r.interleaved is
    # the MD5's domain.
    md5_ok = verify_stream_md5(r.interleaved, r.bits_per_sample,
                               meta["md5"])
    if meta["frames"] != r.stats["frames"]:
        raise AssertionError(f"frames: engine {r.stats['frames']}, "
                             f"baseline {meta['frames']}")
    t_engine, t_cpu = best_times_aba(engine, lambda: baseline(data), reps)
    engine_msps = total / t_engine / 1e6
    chip16 = bench_kernels.bench_stream(16, samples, device, reps)
    chip24 = bench_kernels.bench_stream(24, samples // 2, device, reps)
    return {
        "metric": "decode_throughput",
        "value": engine_msps,
        "unit": "Msamples/s",
        "vs_baseline": engine_msps / (total / t_cpu / 1e6),
        "engine": r.stats["engine"],
        "engine_wall_ms": t_engine * 1e3,
        "baseline_wall_ms": t_cpu * 1e3,
        "bench_samples": int(total),
        "frames": int(r.stats["frames"]),
        "md5_verified": bool(md5_ok),
        "gpu_chip_msps": chip16["pack2_msps"],
        "gpu_chip_msps_24": chip24["pack2_msps"],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "timer": chip16["timer"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int,
                    default=streams.BENCH["bench16"][0])
    ap.add_argument("--reps", type=int,
                    default=int(os.environ.get("BENCH_REPS", REPS)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.samples, args.device, args.reps)
    if torch.device(args.device).type == "cuda":
        print(gpu_line(), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
