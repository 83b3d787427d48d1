"""Device throughput of the pack2 path and of its kernels on the card
(counterpart of tools/bench_tpu.py). Run on the machine with the card:

    python3 -m zflac_tpu_torch.tools.bench_kernels [--samples N]
        [--reps N] [--device cuda|cpu]

Rows:
  stream16  reconstruct_pack2 (rice16, patches, classes with lpc2,
            stack, packtail) on bench16's whole stream as one chunk
            already on the device, per true sample;
  stream24  the same on bench24 at half the samples (rice16, lpc2w,
            the general tail);
  kernels   rice16 and lpc2 on bench16's whole-stream chunk and lpc2w
            on bench24's, each on the sections reconstruct_pack2 hands
            it (the lpc8 class).

The whole-stream chunk is scanned in the card layout decode_to_device
reconstructs (streams.first_chunk), so `h2d_bytes` is that layout's
buffer. Each call is timed from a CUDA graph of 20 calls replayed 25 times
(utils/cudatime.graph_ms), which leaves the host's issue time out as
the TPU tool's on-device loop did. The streams come from
tools/streams.py (.bench_cache/). Prints one JSON object, the card's
`nvidia-smi` line on stderr. With no card it raises; `--device cpu`
runs the same steps on the CPU (the kernels' plain versions) on the
host clock, which is what the CPU tests run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import format as fmt
from ..runtime import device as rt
from ..utils.cudatime import REPS, device_ms, gpu_line
from . import streams


def log(msg: str) -> None:
    print(f"[bench_kernels] {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resident(data: bytes, device):
    """The stream as one card-layout pack2 chunk uploaded to `device`: (chunk,
    buffer, Pack2Geom, container bits, host-clock ms of the upload)."""
    ck = streams.first_chunk(data)
    sync(device)
    t = time.perf_counter()
    buf, geom = rt.chunk_to_torch(ck, device)
    sync(device)
    h2d_ms = (time.perf_counter() - t) * 1e3
    return ck, buf, geom, fmt.container_bits(ck.bits_per_sample), h2d_ms


def bench_stream(bps: int, samples: int, device, reps: int = REPS) -> dict:
    """reconstruct_pack2 on bench stream `bps` (`samples` a channel),
    resident on `device`."""
    ck, buf, geom, cb, h2d_ms = resident(stream_bytes(bps, samples), device)
    ms, timer = device_ms(
        lambda: rt.reconstruct_pack2(buf, geom, container_bits=cb),
        device, reps)
    true_samples = ck.total_block_samples * ck.C
    return {
        "bps": bps,
        "true_samples_per_dispatch": int(true_samples),
        "pack2_exec_ms": ms,
        "pack2_msps": true_samples / ms / 1e3,
        "h2d_bytes": int(ck.device_buf.nbytes),
        "h2d_ms": h2d_ms,
        "timer": timer,
    }


def stream_bytes(bps: int, samples: int) -> bytes:
    """The bench stream of `bps` bits at `samples` a channel."""
    return streams.bench_stream(streams.BY_BPS[bps], samples)


def kernel_inputs(data: bytes, device) -> tuple:
    """(rice16's win, meta and Ssort, the LPC kernel's name and its
    arguments on the first LPC class) of the stream's whole-stream
    chunk on `device`."""
    _, buf, geom, cb, _ = resident(data, device)
    win = geom.sect(buf, "win", geom.W * geom.NGp).view(geom.W, geom.NGp)
    meta = geom.sect(buf, "meta", geom.NGp)
    rows_t = rt.residual_rows(buf, geom)
    lpc = rt.lpc_class_inputs(rows_t, buf, geom)
    return (win, meta, geom.Ssort), (rt.lpc_kernel(geom, cb),
                                     next(iter(lpc.values())))


def bench_kernels(samples: int, device, reps: int = REPS) -> dict:
    """rice16 and lpc2 at bench16's whole-stream shapes, lpc2w at
    bench24's."""
    from ..ops.rice16 import G2, rice16_unpack_rows

    out = {}
    (win, meta, Ssort), lpc16 = kernel_inputs(
        stream_bytes(16, samples), device)
    _, lpc24 = kernel_inputs(stream_bytes(24, samples // 2), device)
    ms, timer = device_ms(lambda: rice16_unpack_rows(win, meta, Ssort=Ssort),
                          device, reps)
    res = G2 * win.shape[1]
    out.update(rice16_res_per_exec=res, rice16_ms=ms,
               rice16_mres_s=res / ms / 1e3)
    for name, args in (lpc16, lpc24):
        fn = rt.LPC_KERNELS[name]
        ms, _ = device_ms(lambda fn=fn, args=args: fn(*args), device, reps)
        B, n = args[0].shape
        out.update({f"{name}_shape": [B, n],
                    f"{name}_samples_per_exec": B * n, f"{name}_ms": ms,
                    f"{name}_msps": B * n / ms / 1e3})
    out["timer"] = timer
    return out


def run(samples: int, device, reps: int = REPS) -> dict:
    device = rt.resolve_device(device)
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "samples": samples, "reps": reps}
    for row, fn in (
            ("stream16", lambda: bench_stream(16, samples, device, reps)),
            ("stream24", lambda: bench_stream(24, samples // 2, device,
                                              reps)),
            ("kernels", lambda: bench_kernels(samples, device, reps))):
        log(f"{row}...")
        t = time.perf_counter()
        res[row] = fn()
        log(f"{row} done in {time.perf_counter() - t:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int,
                    default=streams.BENCH["bench16"][0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.samples, args.device, args.reps)
    if torch.device(args.device).type == "cuda":
        print(gpu_line(), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
