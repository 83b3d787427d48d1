"""Device time of a call on the card, from CUDA events.

`cuda_ms` times batches of back-to-back calls from Python; `graph_ms`
replays calls captured into a CUDA graph, which leaves the host's issue
time out where the call takes less device time than Python takes to
issue it. `gpu_line` names the card beside each number. `device_ms`
picks `graph_ms` for a CUDA device and the host clock for the CPU,
which only the `--device cpu` runs of the tools ask for; the tools then
label their numbers with `timer`.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

REPS = 25


def gpu_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Device time of one fn() call in ms: the median over `reps`
    batches, each bracketed by CUDA events on the current stream. A
    batch runs fn() back to back often enough to last about 1 ms, so
    the card is kept busy and the host's launch latency between calls
    is not counted as device time."""
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


def graph_ms(fn, reps: int = REPS, inner: int = 20) -> float:
    """Device time of one fn() call in ms with the host's issue time
    left out: `inner` calls captured into one CUDA graph (after a
    warm-up on a side stream), the graph replayed, the median over
    `reps` replays bracketed by CUDA events, over `inner`. Between two
    captured kernels the card spends only its own launch gap."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    # The captured calls' outputs live in the graph's own memory pool:
    # free the graph and hand the pool back before the later phases.
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def host_ms(fn, reps: int = REPS) -> float:
    """Host-clock time of one fn() call in ms: the median of `reps`
    calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def device_ms(fn, device, reps: int = REPS) -> tuple:
    """(ms of one fn() call, the timer's name): `graph_ms` on a CUDA
    device, `host_ms` on the CPU."""
    if torch.device(device).type == "cuda":
        return graph_ms(fn, reps), "cuda graph"
    return host_ms(fn, reps), "host clock (cpu)"
