"""End-to-end times of two checkouts on one card, in alternating
processes, so that a change can be held to its parent's spread. Run on
the machine with the card:

    python3 -m zflac_tpu_torch.tools.ab_e2e PARENT CHANGE [--pairs 10]

PARENT and CHANGE are checkout roots (say `git archive`s of the two
commits unpacked under build/). Each measurement is a fresh process
started in one root, so it imports that checkout's zflac_tpu_torch and
its chip_smoke.py (whose bench_stream reads or encodes the bench
streams into that root's .bench_cache/). It times, on bench16 and
bench24, decode_to_device (synchronized) and decode(engine="torch"),
each the median of 5 on the host clock after one warm-up, and
reconstruct_pack2 on the whole-stream chunk (chip_smoke.cuda_ms, CUDA
events), with its host part (one call's return after a synchronize,
median of 25) and its device part (10 calls replayed from a CUDA
graph, median of 25 replays). One process on each side first builds
that side's libraries and is not counted; then the pairs run, each
side first in every other pair. It prints each process's times, and
for each metric both sides' medians and quartiles and the pairs in
which the change was faster.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# Run in a checkout root: that checkout's entry points, on the card.
WORKER = r"""
import json, statistics, time
import torch
import chip_smoke as c
import zflac_tpu_torch
from zflac_tpu_torch import format as fmt
from zflac_tpu_torch.runtime import device as rt

out = {}
for name in ("bench16", "bench24"):
    data = c.bench_stream(name)
    calls = {
        "decode_to_device": lambda: zflac_tpu_torch.decode_to_device(
            data, device="cuda").synchronize(),
        "decode(engine=torch)": lambda: zflac_tpu_torch.decode(
            data, engine="torch", device="cuda"),
    }
    for label, fn in calls.items():
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            a = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - a) * 1e3)
        out[f"{name} {label} ms"] = statistics.median(walls)
    ck = c.first_chunk(data)
    buf, geom = rt.chunk_to_torch(ck, torch.device("cuda", 0))
    cb = fmt.container_bits(ck.bits_per_sample)
    rec = lambda: rt.reconstruct_pack2(buf, geom, container_bits=cb)
    out[f"{name} reconstruct_pack2 ms"] = c.cuda_ms(rec)
    # The host's part: one call's return after a synchronize.
    issue = []
    for _ in range(25):
        torch.cuda.synchronize()
        a = time.perf_counter()
        rec()
        issue.append((time.perf_counter() - a) * 1e3)
    out[f"{name} reconstruct_pack2 issue ms"] = statistics.median(issue)
    # The device's part: 10 calls replayed from a CUDA graph.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rec()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            rec()
    times = []
    for _ in range(25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    out[f"{name} reconstruct_pack2 device ms"] = statistics.median(times)
print(json.dumps(out))
"""


def measure(root: str) -> dict:
    """One worker process in checkout `root`: metric -> ms."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=root, env=env,
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
    for side, root in sides.items():
        measure(root)
        print(f"{side}: warm-up process done ({root})", flush=True)
    runs = {side: [] for side in sides}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            runs[side].append(measure(sides[side]))
            print(f"pair {i} {side}: " + json.dumps(runs[side][-1]),
                  flush=True)
    for metric in runs["parent"][0]:
        p = [r[metric] for r in runs["parent"]]
        c = [r[metric] for r in runs["change"]]
        wins = sum(b < a for a, b in zip(p, c))
        print(f"{metric}: parent median {statistics.median(p):.4f} "
              f"(quartiles {quartiles(p)[0]:.4f}-{quartiles(p)[1]:.4f}), "
              f"change median {statistics.median(c):.4f} (quartiles "
              f"{quartiles(c)[0]:.4f}-{quartiles(c)[1]:.4f}); the change "
              f"faster in {wins} of {len(p)} pairs", flush=True)


if __name__ == "__main__":
    main()
