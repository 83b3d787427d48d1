"""Stage breakdown of reconstruct_pack2 on the card (counterpart of
tools/profile_pack2.py). Run on the machine with the card:

    python3 -m zflac_tpu_torch.tools.profile_pack2 [--bps 16|24|32]
        [--samples N] [--reps N] [--device cuda|cpu]

Each stage runs the port's public stage functions from the uploaded
whole-stream chunk (card layout, streams.first_chunk) up to a cut, and is timed as a whole from a CUDA graph
(utils/cudatime.graph_ms), so the difference between consecutive
stages is what the added piece costs on the device:

    unpack     the rice16 kernel alone ([(GPB+1)*G2, Ssort])
    rows       residual_rows: rice16, patch scatter, warm-up splice,
               tail mask
    stack      + class_stack: the per-class reconstruction (the LPC
               kernel, the fixed class as its lanes) and the dead lane,
               time-major
    transpose  sorted_stack: + the transpose to [Ssort + 1, Bp]
    signal     + stream_rows: the gather into stream order by `inv`
               (the general tail's first step)
    full       reconstruct_pack2 as decode_to_device runs it: packtail
               after the transpose for stereo in an 8/16-bit
               container, else the whole general tail

On bench16 `signal` is not on the path `full` takes (packtail gathers
by itself), so full - transpose, not full - signal, is packtail's part.
Wide chunks (--bps 32, bench32ms: 33-bit side channels) run the same
stages in int64, so every stage is cut there too. The stream is the
bench stream of the bit depth (tools/streams.py). Prints one JSON
object, the card's `nvidia-smi` line on stderr. With no card it raises;
`--device cpu` runs the stages on the CPU on the host clock (the CPU
tests).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.rice16 import rice16_unpack_rows
from ..runtime import device as rt
from ..utils.cudatime import REPS, device_ms, gpu_line
from . import streams
from .bench_kernels import log, resident, stream_bytes

STAGES = ("unpack", "rows", "stack", "transpose", "signal", "full")


def stage_fn(stage: str, buf, geom, cb: int):
    """reconstruct_pack2's work on the chunk up to `stage`, as a call."""
    kw = dict(container_bits=cb)
    inv = rt.tail_inputs(buf, geom)[0]

    def unpack():
        win = geom.sect(buf, "win", geom.W * geom.NGp).view(geom.W,
                                                            geom.NGp)
        return rice16_unpack_rows(win, geom.sect(buf, "meta", geom.NGp),
                                  Ssort=geom.Ssort)

    def stack():
        return rt.class_stack(rt.residual_rows(buf, geom), buf, geom, **kw)

    def transpose():
        return rt.sorted_stack(rt.residual_rows(buf, geom), buf, geom, **kw)

    return {
        "unpack": unpack,
        "rows": lambda: rt.residual_rows(buf, geom),
        "stack": stack,
        "transpose": transpose,
        "signal": lambda: rt.stream_rows(transpose(), inv),
        "full": lambda: rt.reconstruct_pack2(buf, geom, **kw),
    }[stage]


def profile(bps: int, samples: int, device, reps: int = REPS) -> dict:
    device = rt.resolve_device(device)
    ck, buf, geom, cb, _ = resident(stream_bytes(bps, samples), device)
    log(f"chunk: {ck.device_buf.nbytes} bytes, Fp {geom.Fp}, Bp {geom.Bp}, "
        f"Ssort {geom.Ssort}, W {geom.W}, wide {geom.wide}, classes "
        f"{geom.classes}")
    true_samples = ck.total_block_samples * ck.C
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "bps": bps, "samples": samples,
           "true_samples": int(true_samples),
           "tail": ("packtail" if geom.C == 2 and cb in (8, 16)
                    else "general"),
           "stages_ms": {}}
    prev = 0.0
    for stage in STAGES:
        log(f"stage {stage}...")
        ms, res["timer"] = device_ms(stage_fn(stage, buf, geom, cb),
                                     device, reps)
        res["stages_ms"][stage] = {"cumulative": ms, "delta": ms - prev}
        prev = ms
    res["msps_full"] = true_samples / prev / 1e3
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bps", type=int, default=16, choices=(16, 24, 32))
    ap.add_argument("--samples", type=int, default=None,
                    help="samples a channel (default: the bench stream's)")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    samples = args.samples or streams.BENCH[streams.BY_BPS[args.bps]][0]
    res = profile(args.bps, samples, args.device, args.reps)
    if torch.device(args.device).type == "cuda":
        print(gpu_line(), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
