"""End-to-end times of two checkouts on one card, in alternating
processes, so that a change can be held to its parent's spread. Run on
the machine with the card:

    python3 -m zflac_tpu_torch.tools.ab_e2e PARENT CHANGE [--pairs 10]

PARENT and CHANGE are checkout roots (say `git archive`s of the two
commits unpacked under build/). The bench streams (tools/streams.py)
are read or encoded once, by the checkout this tool runs from, and
both sides decode those files. Each measurement is a fresh process
started in one root, so it imports that checkout's zflac_tpu_torch
for the timed code alone: the worker reaches only entry points the
port has had since it gained its sharded decode (decode_to_device,
decode, decode_to_device_sharded, decode_pack2_distributed,
stream_chunks, build_plan, stage_plan, launch_plan,
chunk_to_torch, reconstruct_pack2), so the
parent may be any commit from then on. It times decode(engine="torch")
on bench16_513 (bench16 cut to 513 frames) and, after each call, its
six phases run one by one (host clock, medians of 5 after one warm-up),
with the bytes it stages; and decode_pack2_distributed
in a world of one over two ranges on cuda:0 on bench16 (median of 5 on
the host clock after one warm-up), with the medians of the time spent
in pack2_range a decode (each range's scan and any re-scan) and of its
calls. On bench16, bench24 and bench16_track (bench16's signal at a
3 min 30 s track's length) it times decode_to_device (synchronized,
with the medians of its scan_ms, rescan_ms and enqueue_ms stats), the
median of 5 on the host clock after one warm-up, and counts the bytes
of the scan buffers one call uploads (stream_chunks' chunks, in each
tree's own layout) and the peak device memory one call adds
(max_memory_allocated after reset_peak_memory_stats, less what was
allocated before). On bench16 and bench24 it also times
decode_to_device_sharded over four slots and over one slot of cuda:0
(synchronized) and decode(engine="torch"), each the median of 5 on the
host clock after one warm-up; for one sharded call over four, two and
one slots, in the tree's own chunk shapes, the peak device memory it
adds, the PCM bytes it returns, the scan-buffer bytes it uploads and
reconstruct_pack2 summed over its chunks (every chunk the call passed
to reconstruct_pack2, replayed from one CUDA graph, median of 25
replays); and reconstruct_pack2 on the whole stream as one chunk
(stream_chunks with one worker, in the tree's own layout; batches of
calls between CUDA events, as utils/cudatime.cuda_ms times them), with
its host part (one call's return after a synchronize, median of 25)
and its device part (10 calls replayed from a CUDA graph, median of 25
replays). One
process on each side first builds that side's libraries and is not
counted; then the pairs run, each side first in every other pair. It
prints each process's times, and for each metric both sides' medians
and quartiles and the pairs in which the change's value was lower.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from . import streams

# Run in a checkout root: that checkout's entry points, on the card,
# on the stream files named in argv (name=path).
WORKER = r"""
import json, statistics, sys, time
import torch
import zflac_tpu_torch
from zflac_tpu_torch import format as fmt
from zflac_tpu_torch.bitio import BitReader
from zflac_tpu_torch.index import build_plan, native_indexer
from zflac_tpu_torch.oracle import parse_metadata
from zflac_tpu_torch.parallel.distributed import decode_pack2_distributed
from zflac_tpu_torch.parallel.shard import decode_to_device_sharded
from zflac_tpu_torch.runtime import decode as rd
from zflac_tpu_torch.runtime import device as rt

mesh = [torch.device("cuda", 0)] * 4


# The device memory fn() adds at its peak, in MiB.
def peak_mib(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    del res
    return (torch.cuda.max_memory_allocated() - base) / 2**20

# fn's device time: `calls` calls of it captured in one CUDA graph (after
# one warm-up call on a side stream), the median of 25 replays timed
# with CUDA events, over `calls`, in ms.
def graph_ms(fn, calls):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def cuda_ms(fn, reps=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(100, int(1e-3 / (time.perf_counter() - t))))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# fn once to warm up, then the median of 5 synchronized calls on the
# host clock, in ms.
def median_ms(fn):
    fn()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        a = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - a) * 1e3)
    return statistics.median(walls)


# decode_pack2_distributed in a world of one over two ranges on cuda:0:
# its time, and the medians of the time spent in pack2_range (the scans,
# and any re-scan) and of its calls a decode.
def pack2_distributed(data):
    real = native_indexer.pack2_range
    scans, per_call = [], []

    def timed(*args, **kw):
        a = time.perf_counter()
        ck = real(*args, **kw)
        scans.append((time.perf_counter() - a) * 1e3)
        return ck

    def call():
        scans.clear()
        decode_pack2_distributed(data, devices=["cuda:0"] * 2)
        per_call.append((sum(scans), len(scans)))

    native_indexer.pack2_range = timed
    try:
        ms = median_ms(call)
    finally:
        native_indexer.pack2_range = real
    return (ms, statistics.median(s for s, _ in per_call[1:]),
            statistics.median(n for _, n in per_call[1:]))


# decode(engine="torch") on the card and, after each call, the same
# steps run one by one (build_plan, stage_plan, launch_plan, the device
# wait, the copy back and assembly, MD5): after one warm-up, the medians
# of 5 of the whole call and of each phase on the host clock, and the
# bytes stage_plan stages.
ROWS_PHASES = ("plan build", "padding and packing", "H2D + enqueue",
               "device wait", "D2H + assembly", "MD5 + normalization")


def rows_phases(name, data):
    zflac_tpu_torch.decode(data, engine="torch", device="cuda")
    walls, phases = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a = time.perf_counter()
        zflac_tpu_torch.decode(data, engine="torch", device="cuda")
        walls.append((time.perf_counter() - a) * 1e3)
        torch.cuda.synchronize()
        ts = [time.perf_counter()]
        plan = build_plan(data)
        ts.append(time.perf_counter())
        staged = rd.stage_plan(plan)
        ts.append(time.perf_counter())
        pcm = rd.launch_plan(staged, "cuda")
        ts.append(time.perf_counter())
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        host = rd._assemble(plan, pcm[:plan.num_frames].cpu().numpy())
        ts.append(time.perf_counter())
        rd._finish(host, plan.info.bits_per_sample, plan.info.md5, True)
        ts.append(time.perf_counter())
        phases.append([(b - a) * 1e3 for a, b in zip(ts, ts[1:])])
    res = {f"{name} decode(engine=torch) ms": statistics.median(walls),
           f"{name} rows staged bytes": staged.buf.nbytes}
    for i, label in enumerate(ROWS_PHASES):
        res[f"{name} rows {label} ms"] = statistics.median(
            p[i] for p in phases)
    return res


# decode_to_device on the card: after one warm-up, the median of 5
# synchronized calls on the host clock and the medians of their
# scan_ms, rescan_ms and enqueue_ms; the bytes of the scan buffers one
# call uploads (stream_chunks' chunks, in the tree's own layout) and the
# device memory one call adds at its peak.
def to_device(name, data):
    stats = []
    res = {f"{name} decode_to_device ms": median_ms(lambda: stats.append(
        zflac_tpu_torch.decode_to_device(
            data, device="cuda").synchronize().stats))}
    for key in ("scan_ms", "rescan_ms", "enqueue_ms"):
        res[f"{name} decode_to_device {key}"] = statistics.median(
            st[key] for st in stats[1:])
    br = BitReader(data)
    res[f"{name} decode_to_device upload bytes"] = sum(
        ck.device_buf.nbytes for ck in rt.stream_chunks(
            data, parse_metadata(br), br.pos // 8))
    res[f"{name} decode_to_device peak MiB"] = peak_mib(
        lambda: zflac_tpu_torch.decode_to_device(data, device="cuda"))
    return res


# One decode_to_device_sharded call over `slots` slots of cuda:0, in
# the tree's own chunk shapes: the device memory it adds at its peak,
# the PCM bytes it returns, the scan-buffer bytes it uploads, and
# reconstruct_pack2 on every chunk it reconstructed (the calls it made
# through rt.reconstruct_pack2, recorded), all replayed from one CUDA
# graph.
def sharded_call(name, data, slots):
    key = f"{name} decode_to_device_sharded {slots} slot" + (
        "s" if slots > 1 else "")
    res = {f"{key} peak MiB": peak_mib(
        lambda: decode_to_device_sharded(data, mesh[:slots]))}
    real, seen = rt.reconstruct_pack2, []

    def recorded(buf, geom, **kw):
        seen.append((buf, geom, kw))
        return real(buf, geom, **kw)

    rt.reconstruct_pack2 = recorded
    try:
        rounds, _ = decode_to_device_sharded(data, mesh[:slots])
    finally:
        rt.reconstruct_pack2 = real
    res[f"{key} PCM bytes"] = sum(t.numel() * t.element_size()
                                  for rnd in rounds for t in rnd)
    res[f"{key} upload bytes"] = sum(b.numel() * b.element_size()
                                     for b, _, _ in seen)
    res[f"{key} reconstruct_pack2 summed device ms"] = graph_ms(
        lambda: [real(b, g, **kw) for b, g, kw in seen], 1)
    return res


out = {}
for arg in sys.argv[1:]:
    name, path = arg.split("=", 1)
    with open(path, "rb") as f:
        data = f.read()
    if name == "bench16_513":  # the rows engine's stream alone
        out.update(rows_phases(name, data))
        continue
    out.update(to_device(name, data))
    if name == "bench16_track":  # decode_to_device's stream alone
        continue
    if name == "bench16":
        key = f"{name} decode_pack2_distributed 2 ranges"
        (out[f"{key} ms"], out[f"{key} pack2_range ms"],
         out[f"{key} pack2_range calls"]) = pack2_distributed(data)
    calls = {
        "decode_to_device_sharded 4 slots": lambda: (
            decode_to_device_sharded(data, mesh), torch.cuda.synchronize()),
        "decode_to_device_sharded 1 slot": lambda: (
            decode_to_device_sharded(data, mesh[:1]),
            torch.cuda.synchronize()),
        "decode(engine=torch)": lambda: zflac_tpu_torch.decode(
            data, engine="torch", device="cuda"),
    }
    for label, fn in calls.items():
        out[f"{name} {label} ms"] = median_ms(fn)
    for slots in (4, 2, 1):
        out.update(sharded_call(name, data, slots))
    # The whole stream as one chunk, in the tree's own decode layout.
    br = BitReader(data)
    ck = rt.stream_chunks(data, parse_metadata(br), br.pos // 8,
                          chunk_frames=1 << 20, scan_workers=1)[0]
    buf, geom = rt.chunk_to_torch(ck, torch.device("cuda", 0))
    cb = fmt.container_bits(ck.bits_per_sample)
    rec = lambda: rt.reconstruct_pack2(buf, geom, container_bits=cb)
    out[f"{name} reconstruct_pack2 ms"] = cuda_ms(rec)
    # The host's part: one call's return after a synchronize.
    issue = []
    for _ in range(25):
        torch.cuda.synchronize()
        a = time.perf_counter()
        rec()
        issue.append((time.perf_counter() - a) * 1e3)
    out[f"{name} reconstruct_pack2 issue ms"] = statistics.median(issue)
    # The device's part: 10 calls replayed from a CUDA graph.
    out[f"{name} reconstruct_pack2 device ms"] = graph_ms(rec, 10)
print(json.dumps(out))
"""


def measure(root: str, files: list) -> dict:
    """One worker process in checkout `root` on `files` (name=path):
    metric -> value (ms, bytes or MiB, as its name says)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", WORKER, *files], cwd=root,
                          env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"worker in {root} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def quartiles(xs) -> tuple:
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    files = []
    for name in ("bench16", "bench24"):
        streams.bench_stream(name)
        files.append(f"{name}={streams.bench_path(name)}")
    for label, n in (("bench16_513", streams.ODD_SAMPLES),
                     ("bench16_track", streams.TRACK_SAMPLES)):
        streams.bench_stream("bench16", n)
        files.append(f"{label}={streams.bench_path('bench16', n)}")
    for side, root in sides.items():
        measure(root, files)
        print(f"{side}: warm-up process done ({root})", flush=True)
    runs = {side: [] for side in sides}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            runs[side].append(measure(sides[side], files))
            print(f"pair {i} {side}: " + json.dumps(runs[side][-1]),
                  flush=True)
    for metric in runs["parent"][0]:
        if metric not in runs["change"][0]:
            continue
        p = [r[metric] for r in runs["parent"]]
        c = [r[metric] for r in runs["change"]]
        wins = sum(b < a for a, b in zip(p, c))
        print(f"{metric}: parent median {statistics.median(p):.4f} "
              f"(quartiles {quartiles(p)[0]:.4f}-{quartiles(p)[1]:.4f}), "
              f"change median {statistics.median(c):.4f} (quartiles "
              f"{quartiles(c)[0]:.4f}-{quartiles(c)[1]:.4f}); the change "
              f"lower in {wins} of {len(p)} pairs", flush=True)


if __name__ == "__main__":
    main()
