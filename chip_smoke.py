#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zflac_tpu_torch) on one NVIDIA
GPU. Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels (zflac_tpu_torch/csrc) and the host scan
library (zflac_tpu_torch/index/native) from the checkout's sources into
build/zflac_tpu_torch/, then:

  1. prints the card (nvidia-smi name and power limit), torch and CUDA;
  2. builds the kernels (one nvcc per source) and the scan library at
     once, times the build and prints ptxas's registers and spills for
     the ring kernels (lpc2, lpc2w and lpc2w33 at hist 8/16/32, lpc at
     int32 and int64);
  3. makes the streams: three full-width bench streams of correlated
     stereo, block 4096, 44.1 kHz, encoded in parallel processes and
     cached in .bench_cache/ (bench16: bench.py's 2**22 samples per
     channel at 16 bits; bench24: the JAX package's stream24 row,
     2**21 samples at 24 bits; bench32ms: 2**20 samples at 32 bits,
     mid-side, whose 33-bit side channels make wide chunks), and every
     corpus stream;
  4. holds each kernel bit for bit against its plain PyTorch version on
     the card: rice16, rice16_flat, lpc2, packtail, lpc2w and lpc2w33 on
     every stream's real pack2 chunk sections, lpc and lpc64 on the LPC
     classes of every stream's rows-engine plan (gathered as the rows
     engine gathers them, a safe_lpc plan of bench16 too), and all of
     them on seeded synthetic inputs (rice16, rice16_flat and packtail
     from the CPU tests' generators at the bench chunks' shapes, with
     Rice parameters up to 61, unary runs across words, Fp 1, Bp not a
     multiple of 4 or 8 and inputs at an odd offset; the five ring
     kernels over hist 8/16/32, 1 to 2048 lanes, B 8 to 4096, orders
     0-32, every shift amount, unaligned lane slices, warps of one
     launch that take different histories and shift forms); then times
     each kernel and its plain version at the bench shapes (CUDA events,
     median of 25 batches of back-to-back calls after warm-up; 5 for the
     plain lpc and lpc64, a Python loop of 4096 steps; rice16,
     rice16_flat and packtail, whose launches take less device time than
     the host's issue, from 25 replays of a CUDA graph of 20 calls)
     beside its bound,
     lpc64 also on bench32ms's rows class and bench16's safe_lpc class,
     the redesigned kernels at hist 32, and rice16, packtail and the LPC
     kernel on each chunk decode_to_device reconstructs for bench16,
     bench24 and bench32ms (the LPC kernels in ns a step), summed per
     call against the summed bound;
  5. drives both main paths, each with the launch counters reset just
     before and read just after (each kernel of the path must have
     launched): decode_to_device on each bench stream, and the rows
     engine, decode(engine="torch"), on each bench stream; checks the
     PCM against the encoder's input and the native C++ decoder, with
     the stream MD5 verified; then the same for every corpus stream
     through both engines, bench16 in 256-frame chunks, and a corrupted
     stream that must raise InvalidChecksum;
  6. runs the rows engine's other entry points on the card:
     decode_pipelined on bench16 (several chunks), stream_decode on
     bench24, decode_range on bench16 (three ranges) and decode_tolerant
     on a corrupted corpus stream (against the same call on the CPU);
  7. times the device reconstruction of each bench chunk, the whole
     decode_to_device call on bench16 and bench24, and decode(engine=
     "torch") on both, end to end and in its phases;
  8. faults: empty shapes (B == 0, n == 0, NGp == 0, Fp == 0) through
     every kernel wrapper on the card give the plain versions' empty
     results without a launch; a decode leaves the thread's current
     CUDA device as it found it, and, on a host with several cards, a
     decode on cuda:1 from a thread on cuda:0 equals the cuda:0 result;
  9. sharded: decode_to_device_sharded of each bench stream over every
     visible card (over four slots on cuda:0 when there is one), with
     the launch counters reset before and read after (rice16, the LPC
     kernel and packtail must equal the live chunks times their
     classes), sharded_to_host against the encoder's input with the
     MD5 verified, the completeness count against the block sizes, one
     case of three or more rounds, and every kernel against its plain
     version on each chunk of each of these calls (their own chunk
     sizes and union geometry); reconstruct_sharded on each bench
     stream's rows plan against the single-device reconstruction
     (lpc / lpc64 counted, and held against the plain version on each
     device's slice of the plan); then the sharded decode of bench16 and
     bench24 timed on the host clock (median of 5), in turns with
     decode_to_device on one device, beside the time of step 7;
 10. longstream: decode_longstream of bench16 and bench24 in 4 shards
     (launches counted; lpc / lpc64 against the plain version on each
     shard's plan);
 11. distributed: two worker processes that share cuda:0, over gloo
     (python3 -m zflac_tpu_torch.parallel.distributed ... pack2 cuda:0,
     then ... longstream cuda:0), on bench16: both outputs must equal
     the encoder's input, and the launch counts each worker prints
     must be those of its chunk or shard; the kernels are held against
     their plain versions on the two workers' chunks and plans;
 12. cli: python3 -m zflac_tpu_torch.cli decode, verify and bench on
     bench16 as three processes at once (the WAV's payload must equal
     the encoder's input), and verify once more through cli.main in
     this process with the launches counted;
 13. profile: one decode of bench16 in a process with
     ZFLAC_TPU_PROFILE set; the trace file must hold the region's label
     and one of the port's kernels.

With --compare-csrc CSRC (another checkout's zflac_tpu_torch/csrc, say
the parent commit's, unpacked under build/), step 4 also builds that
tree's rice16 and packtail (tools/kernel_ab.py) and times them beside
this checkout's, from CUDA graphs and in turns, on each bench stream's
whole-stream chunk and decode_to_device chunks, after checking that
both give the same output.

Any failure raises, and the exit code is then not 0. With no CUDA
device it exits 1 before doing anything. The last lines are one JSON
object with a record per kernel (launches on the main paths, max
|kernel - plain|, its time, the plain version's, its bound and what
bounds it; no single PyTorch call computes any of these functions, so
library_ms is null), the nvidia-smi line, and {"ok": true, "device":
{...}}. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import json
import multiprocessing
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

import zflac_tpu_torch
from zflac_tpu_torch import _kernels, cli
from zflac_tpu_torch import format as fmt
from zflac_tpu_torch.bitio import BitReader
from zflac_tpu_torch.encoder import EncoderConfig, encode
from zflac_tpu_torch.errors import InvalidChecksum
from zflac_tpu_torch.index import build_plan, native_indexer
from zflac_tpu_torch.index.native_indexer import (decode_cpu_native,
                                                  pack2_range)
from zflac_tpu_torch.oracle import parse_metadata
from zflac_tpu_torch.parallel import make_mesh, reconstruct_sharded
from zflac_tpu_torch.parallel.distributed import union_chunks
from zflac_tpu_torch.parallel.longstream import (decode_longstream,
                                                 shard_index)
from zflac_tpu_torch.parallel.shard import (decode_to_device_sharded,
                                            local_arrays, shard_plan,
                                            sharded_to_host)
from zflac_tpu_torch.result import container_dtype
from zflac_tpu_torch.testing import correlated_stereo, make_corpus
from zflac_tpu_torch.ops.lpc import (KERNEL as LPC_ROWS_KERNEL,
                                     lpc_reconstruct, lpc_reconstruct_ref)
from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct_ref
from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct_ref,
                                       lpc2w_reconstruct_ref)
from zflac_tpu_torch.ops.packtail import packtail, packtail_ref
from zflac_tpu_torch.ops.rice16 import (rice16_unpack, rice16_unpack_ref,
                                        rice16_unpack_rows,
                                        rice16_unpack_rows_ref)
from zflac_tpu_torch.runtime import decode as rd
from zflac_tpu_torch.runtime import device as rt
from zflac_tpu_torch.runtime.reconstruct import lpc_class_inputs
from zflac_tpu_torch.tools import kernel_ab
from zflac_tpu_torch.tools.kernel_inputs import packtail_inputs, rice_groups
from zflac_tpu_torch.tools.kernel_sass import kernel_name

BENCH_BLOCK = 4096
# name -> (samples per channel, bits per sample, stereo mode, the
# kernels its decode_to_device path must launch).
BENCH = {
    "bench16": (1 << 22, 16, None, ("rice16", "lpc2", "packtail")),
    "bench24": (1 << 21, 24, None, ("rice16", "lpc2w")),
    "bench32ms": (1 << 20, 32, "mid_side", ("rice16", "lpc2w33")),
}
# The kernels each bench stream's rows-engine path must launch.
ROWS_PATH = {"bench16": ("lpc",), "bench24": ("lpc64",),
             "bench32ms": ("lpc64",)}
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
REPS = 25
# Batches for the plain lpc and lpc64 (4096 Python-loop steps a call).
PLAIN_LPC_REPS = 5
# Frames per chunk for decode_pipelined and stream_decode (8 and 4
# chunks on bench16 and bench24).
PIPE_FRAMES = 128

KERNELS = {
    # name -> (source in the repo, the Pallas kernel's entry it replaces)
    "rice16": ("zflac_tpu_torch/csrc/rice16.cu",
               "zflac_tpu/ops/rice16.py:231"),
    "lpc2": ("zflac_tpu_torch/csrc/lpc2.cu", "zflac_tpu/ops/lpc2.py:88"),
    "packtail": ("zflac_tpu_torch/csrc/packtail.cu",
                 "zflac_tpu/ops/packtail.py:54"),
    "lpc2w": ("zflac_tpu_torch/csrc/lpc2w.cu", "zflac_tpu/ops/lpc2w.py:134"),
    "lpc2w33": ("zflac_tpu_torch/csrc/lpc2w.cu",
                "zflac_tpu/ops/lpc2w.py:297"),
    "lpc": ("zflac_tpu_torch/csrc/lpc.cu", "zflac_tpu/ops/lpc.py:81"),
    # Not a Pallas kernel: the XLA scan the JAX rows engine runs at int64.
    "lpc64": ("zflac_tpu_torch/csrc/lpc.cu",
              "zflac_tpu/runtime/reconstruct.py:67"),
    # K1's kernel with Ssort = NG: the flat layout (on no decode path).
    "rice16_flat": ("zflac_tpu_torch/csrc/rice16.cu",
                    "zflac_tpu/ops/rice16.py:160"),
}
LPC_PLAIN = {"lpc2": lpc2_reconstruct_ref, "lpc2w": lpc2w_reconstruct_ref,
             "lpc2w33": lpc2w33_reconstruct_ref}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def seconds(fn) -> float:
    """Seconds fn() takes."""
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def ptxas_summary() -> list:
    """ptxas's registers, stack and spills for each instantiation of
    the ring kernels (lpc2, lpc2w, lpc2w33, lpc), from the build's
    report."""
    out, name = [], None
    with open(_kernels.PTXAS_REPORT) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = kernel_name(m.group(1))
            elif name and ("Used" in line or "spill" in line):
                out.append(f"ptxas {name}: {line.split(' : ')[-1].strip()}")
    return out


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bench_pcm(name: str) -> np.ndarray:
    n, bps, _, _ = BENCH[name]
    return correlated_stereo(n, bps, seed=7)


def bench_path(name: str) -> str:
    n, bps, mode, _ = BENCH[name]
    return os.path.join(
        CACHE, f"bench_{n}_{bps}bit_{BENCH_BLOCK}"
        f"{'_' + mode if mode else ''}.flac")


def bench_stream(name: str) -> bytes:
    """Bench stream `name`, from its cache file when present, else
    encoded and cached."""
    n, bps, mode, _ = BENCH[name]
    path = bench_path(name)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    cfg = EncoderConfig(block_size=BENCH_BLOCK,
                        **({"stereo_mode": mode} if mode else {}))
    data = encode(bench_pcm(name), 44100, bps, cfg)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return data


def expected_pcm(pcm: np.ndarray, bps: int) -> np.ndarray:
    """Decoder output for encoder input `pcm`: samples shifted to the
    container's MSBs (zflac.zig:287-306), interleaved."""
    shift = fmt.normalization_shift(bps)
    return (pcm.astype(np.int64) << shift).astype(
        container_dtype(bps)).reshape(-1)


def first_chunk(data: bytes):
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 20)
    if ck is None:
        raise RuntimeError("pack2 scan declined the stream")
    return ck


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


# The kernels whose launch takes less device time than the host takes
# to issue it from Python, at the main path's shapes: their batches of
# back-to-back calls measure the host, so they are timed from a graph.
STREAMING = ("rice16", "rice16_flat", "packtail")


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


class Diff:
    """Running max |kernel - plain| per kernel; any nonzero fails."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}

    def check(self, name: str, what: str, got, want) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{name} on {what}: kernel {tuple(got.shape)} {got.dtype} "
                f"vs plain {tuple(want.shape)} {want.dtype}")
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        self.err[name] = max(self.err[name], err)
        if err:
            raise AssertionError(f"{name} on {what}: max |kernel - plain| "
                                 f"= {err}")


def kernel_checks(dev, diff: Diff, what: str, ck) -> dict:
    """Each kernel of the chunk's path against its plain version, on
    the chunk's real sections: rice16 (and its flat layout,
    rice16_flat), the chunk's LPC kernel on each LPC class, and
    packtail where the chunk takes it (stereo in an 8/16-bit
    container). Returns the kernel inputs."""
    buf, geom = rt.chunk_to_torch(ck, dev)
    win = geom.sect(buf, "win", geom.W * geom.NGp).view(geom.W, geom.NGp)
    meta = geom.sect(buf, "meta", geom.NGp)
    diff.check("rice16", what,
               rice16_unpack_rows(win, meta, Ssort=geom.Ssort),
               rice16_unpack_rows_ref(win, meta, Ssort=geom.Ssort))
    diff.check("rice16_flat", what, rice16_unpack(win, meta),
               rice16_unpack_ref(win, meta))
    cb = fmt.container_bits(ck.bits_per_sample)
    rows_t = rt.residual_rows(buf, geom)
    lpc_name = rt.lpc_kernel(geom, cb)
    lpc = rt.lpc_class_inputs(rows_t, buf, geom)
    for cname, args in lpc.items():
        diff.check(lpc_name, f"{what} {cname}",
                   rt.LPC_KERNELS[lpc_name](*args),
                   LPC_PLAIN[lpc_name](*args))
    stack = rt.sorted_stack(rows_t, buf, geom, container_bits=cb)
    tail = rt.tail_inputs(buf, geom)
    if geom.C == 2 and cb in (8, 16):
        diff.check("packtail", what,
                   packtail(stack, *tail, Fp=geom.Fp, container_bits=cb),
                   packtail_ref(stack, *tail, Fp=geom.Fp,
                                container_bits=cb))
    return dict(buf=buf, geom=geom, win=win, meta=meta, lpc=lpc,
                lpc_name=lpc_name, stack=stack, tail=tail, cb=cb)


def class_lpc_checks(diff: Diff, what: str, t: dict, lists: dict) -> dict:
    """lpc / lpc64 against their plain version on plan tensors `t`
    (rows, coeffs, shift, order), gathered by the padded class lists
    `lists` ("lpc" at the rows' dtype, "lpc_wide" widened to int64) as
    reconstruct_core gathers them. Returns class name -> kernel
    arguments."""
    out = {}
    for name, idx in lists.items():
        args = lpc_class_inputs(t["rows"], t["coeffs"], t["shift"],
                                t["order"], idx, widen=name == "lpc_wide")
        diff.check(LPC_ROWS_KERNEL[args[0].dtype], f"{what} {name}",
                   lpc_reconstruct(*args), lpc_reconstruct_ref(*args))
        out[name] = args
    return out


def rows_lpc_checks(dev, diff: Diff, what: str, plan,
                    safe_lpc: bool = False) -> dict:
    """class_lpc_checks on the LPC classes of a rows-engine plan,
    padded and uploaded as _run_reconstruct does it."""
    if safe_lpc:
        plan.wide = plan.kind == 3
    arrays, class_idx = rd.pad_plan(plan)
    t, ci = rd.plan_to_torch(arrays, class_idx, dev)
    return class_lpc_checks(diff, what, t, {
        name: ci[name] for name in ("lpc", "lpc_wide") if name in ci})


# Shift amounts for the wide recurrences: every value the buffer's
# 5-bit field carries, and out-of-range ones only a corrupt buffer
# holds (the JAX step math defines them too).
SHIFTS = np.array([*range(32), 32, 33, 40, 63, 64, 100, -1, -32,
                   2**31 - 1, -2**31], np.int32)


def hires_inputs(rng, n: int, B: int, hist: int, warm_bits: int):
    """Seeded high-res recurrences: orders 1..hist, coefficients of up
    to 15 bits with sum|c| <= 2^shift so the samples stay bounded,
    warm-ups of `warm_bits` bits and small residuals, so the 64-bit
    sums pass 2^32 by far; shifts from SHIFTS (10..15 on most lanes)."""
    order = rng.integers(1, hist + 1, n).astype(np.int32)
    shift = rng.integers(10, 16, n).astype(np.int32)
    shift[:len(SHIFTS)] = SHIFTS[:n]
    cf = np.zeros((hist, n), np.int32)
    rows = rng.integers(-1024, 1025, (B, n)).astype(np.int64)
    lim = 1 << (warm_bits - 1)
    for i in range(n):
        o = order[i]
        cap = max(1, (1 << int(min(max(shift[i], 0), 15))) // int(o))
        cf[:o, i] = rng.integers(-cap, cap + 1, o)
        rows[:o, i] = rng.integers(-lim, lim, o)[:B]
    return rows, cf, shift, order


# Lane counts, block sizes and the column offset of the lane slices in
# ring_checks: n 1 and 31 leave a warp partly idle, 33 adds a second
# block of one lane, 2048 is bench16's class; B 8 is one short group of
# steps, 128 one stage of the ring, 200 a stage and a rest of two long
# groups and a short one, 4096 the bench block.
RING_N = (1, 31, 33, 256, 2048)
RING_B = (8, 128, 200, 4096)
RING_COL = 3
HISTS = (8, 16, 32)


def ring_fns(name: str):
    """(kernel wrapper, plain version) of ring kernel `name`."""
    if name in LPC_PLAIN:
        return rt.LPC_KERNELS[name], LPC_PLAIN[name]
    return lpc_reconstruct, lpc_reconstruct_ref


def hist_of(name: str, cf) -> int:
    """The history a ring kernel runs on coefficients cf: its rows for
    lpc2, lpc2w and lpc2w33; for lpc and lpc64 (rows layout) the
    smallest of 8, 16 and 32 that covers the highest nonzero row of any
    lane, which the widest warp picks."""
    if name not in ("lpc", "lpc64"):
        return cf.shape[0]
    live = torch.nonzero(cf.flip(0).ne(0).any(dim=1)).flatten()
    top = int(live.max()) + 1 if live.numel() else 0
    return next(h for h in HISTS if top <= h)


def ring_inputs(rng, name: str, n: int, B: int, hist: int):
    """Seeded inputs for a ring kernel over every order 0..32 (warm-ups
    longer than the history too) and every shift of SHIFTS (lanes 32-41,
    the second warp, hold the out-of-range ones, so that warp alone
    takes lpc2w33's and lpc64's shift rule): lpc2's and lpc's 15-bit
    coefficients wrap int32; lpc2w, lpc2w33 and lpc64 take hires_inputs'
    bounded signals (30-bit, 33-bit and 33-bit) whose 64-bit sums pass
    2^32, and past 32 lanes lpc2w gives the last lane 21-bit
    coefficients, so the last warp runs lpc2w's int64 step and the
    others its float64 step. lpc and lpc64 take the rows engine's
    layout ([32, n], row j for s[t-32+j]) with warp w's coefficients
    nonzero up to row 8, 16 or 32 in turn, from `hist` for warp 0, so
    the warps of one launch pick different histories; past 32 lanes the
    last lane has one nonzero coefficient, in the oldest row."""
    rows_engine = name in ("lpc", "lpc64")
    H = 32 if rows_engine else hist
    if name in ("lpc2w", "lpc2w33", "lpc64"):
        rows, cf, shift, order = hires_inputs(rng, n, B, H,
                                              30 if name == "lpc2w" else 33)
        if name == "lpc2w" and n > 32:  # the last warp's last lane
            cf[:, -1] = rng.integers(-2**20, 2**20, hist)
    else:
        rows = rng.integers(-(1 << 15), 1 << 15, (B, n))
        cf = rng.integers(-(1 << 14), 1 << 14, (H, n))
        shift = rng.integers(0, 16, n)
        shift[:len(SHIFTS)] = SHIFTS[:n]
    order = rng.integers(0, 33, n)
    order[:33] = np.arange(33)[:n]
    top = order
    if rows_engine:
        first = HISTS.index(hist)
        top = np.minimum(order, [HISTS[(first + s // 32) % 3]
                                 for s in range(n)])
    cf = cf * (np.arange(H)[:, None] < top[None, :])
    if rows_engine:
        if n > 32:
            cf[:, -1] = 0
            cf[31, -1] = 3
        cf = cf[::-1]
    dtype = np.int64 if name in ("lpc2w33", "lpc64") else np.int32
    return (rows.astype(dtype), np.ascontiguousarray(cf, dtype=np.int32),
            shift.astype(np.int32), order.astype(np.int32))


def ring_checks(rng, t, diff: Diff) -> None:
    """The ring kernels (lpc2, lpc2w, lpc2w33, lpc, lpc64) bit for bit
    against their plain versions at hist 8/16/32 (for lpc and lpc64 the
    history warp 0 picks), every n of RING_N and B of RING_B, with rows
    and coefficients as lane slices of wider arrays: starting at column
    RING_COL with an odd row stride, so neither base address nor row
    stride is 16-byte aligned (the ring's one-value copies), and
    starting at column 0 with a stride of whole 16-byte units (its
    16-byte copies, in every block whose 32 lanes exist)."""
    for name in ("lpc2", "lpc2w", "lpc2w33", "lpc", "lpc64"):
        kern, plain = ring_fns(name)
        for hist in HISTS:
            for n in RING_N:
                for B in RING_B:
                    for col, right in ((RING_COL, 4 + n % 2),
                                       (0, 4 + (-n) % 4)):
                        rows, cf, shift, order = ring_inputs(
                            rng, name, n, B, hist)
                        pad = lambda a: np.pad(  # noqa: E731
                            a, ((0, 0), (col, right)))
                        sl = slice(col, col + n)
                        args = (t(pad(rows))[:, sl], t(pad(cf))[:, sl],
                                t(shift), t(order))
                        aligned = (args[0].data_ptr() % 16 == 0
                                   and args[0].stride(0) % 4 == 0)
                        assert aligned == (col == 0)
                        diff.check(name, f"synthetic hist={hist} n={n} "
                                   f"B={B} column {col}", kern(*args),
                                   plain(*args))


def misaligned(a: np.ndarray, dev):
    """A contiguous int32 copy of `a` on `dev` whose data starts 4 bytes
    past a 16-byte boundary: a view at an odd offset into a larger
    allocation."""
    flat = torch.empty(a.size + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.data_ptr() % 16 == 4
    return view


def streaming_checks(dev, diff: Diff, rice_shapes, tail_shapes) -> list:
    """rice16, rice16_flat and packtail bit for bit against their plain
    versions on kernel_inputs' seeded inputs (the generators of the CPU
    tests): rice16 in both modes (the adversarial one: k 0-63, skips
    0-8, sparse windows) at each (W, Ssort, p-rows) of rice_shapes, in
    the rows layout, in the flat one (NGp = Ssort) and with win and meta
    at an odd offset (the kernel's 4-byte copies), and at an NGp that is
    not a multiple of 4; packtail at each (Fp, Bp) of tail_shapes and at
    Fp 1 and Bp not a multiple of 4 or 8, in both containers, with two
    row indices out of range (clamped) and with the stack at an odd
    offset (the kernel's scalar path). Returns what was checked."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    done = []
    for W, Ssort, GP1 in [*rice_shapes, (8, 130, 3), (16, 258, 1)]:
        for adversarial in (False, True):
            win, meta = rice_groups(rng, W, GP1 * Ssort, adversarial)
            what = (f"W={W} Ssort={Ssort} NGp={GP1 * Ssort}"
                    f"{' adversarial' if adversarial else ''}")
            w_t, m_t = t(win.view(np.int32)), t(meta)
            diff.check("rice16", what,
                       rice16_unpack_rows(w_t, m_t, Ssort=Ssort),
                       rice16_unpack_rows_ref(w_t, m_t, Ssort=Ssort))
            diff.check("rice16_flat", what, rice16_unpack(w_t, m_t),
                       rice16_unpack_ref(w_t, m_t))
            w_o = misaligned(win.view(np.int32), dev)
            m_o = misaligned(meta, dev)
            diff.check("rice16", f"{what} at an odd offset",
                       rice16_unpack_rows(w_o, m_o, Ssort=Ssort),
                       rice16_unpack_rows_ref(w_o, m_o, Ssort=Ssort))
            done.append(what)
    for Fp, Bp in [*tail_shapes, (1, 4096), (5, 4095), (7, 4092), (3, 100)]:
        for cb in (16, 8):
            stack, inv, wasted, chcode = packtail_inputs(rng, Fp, Bp)
            inv[0], inv[-1] = -5, stack.shape[0] + 3
            what = f"Fp={Fp} Bp={Bp} container {cb}"
            args = (t(stack), t(inv), t(wasted), t(chcode))
            diff.check("packtail", what,
                       packtail(*args, Fp=Fp, container_bits=cb),
                       packtail_ref(*args, Fp=Fp, container_bits=cb))
            args = (misaligned(stack, dev), *args[1:])
            diff.check("packtail", f"{what}, stack at an odd offset",
                       packtail(*args, Fp=Fp, container_bits=cb),
                       packtail_ref(*args, Fp=Fp, container_bits=cb))
            done.append(what)
    return done


def synthetic_checks(dev, diff: Diff, rice_shapes, tail_shapes) -> list:
    """Seeded inputs beyond what the streams reach: rice16, rice16_flat
    and packtail as streaming_checks says, at the bench chunks' shapes
    rice_shapes and tail_shapes and at odd ones; lpc2 and lpc2w as
    ring_checks says; lpc2w33, lpc and lpc64 with orders up to the
    history and the whole shift range. Returns streaming_checks'
    list."""
    done = streaming_checks(dev, diff, rice_shapes, tail_shapes)
    rng = np.random.default_rng(2024)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    ring_checks(rng, t, diff)
    for hist in (8, 16, 32):
        for B in (640, 1152):
            rows, cf, shift, order = hires_inputs(rng, 256, B, hist, 33)
            args = (t(rows), t(cf), t(shift), t(order))
            diff.check("lpc2w33", f"synthetic hist={hist} B={B}",
                       rt.LPC_KERNELS["lpc2w33"](*args),
                       LPC_PLAIN["lpc2w33"](*args))
    for dtype, warm_bits in ((np.int32, 16), (np.int64, 33)):
        for B in (256, 640, 4608):
            rows, cf, shift, order = hires_inputs(rng, 256, B, 32,
                                                  warm_bits)
            if dtype == np.int32:   # 14-bit coefficients: int32 wraps
                cf = rng.integers(-(1 << 13), 1 << 13, cf.shape) * (
                    np.arange(32)[:, None] < order[None, :])
            # The rows engine's coefficient layout: row j multiplies
            # s[t-32+j], the reverse of cfwd's.
            args = (t(rows.astype(dtype)),
                    t(np.ascontiguousarray(cf[::-1], dtype=np.int32)),
                    t(shift), t(order))
            name = LPC_ROWS_KERNEL[args[0].dtype]
            diff.check(name, f"synthetic B={B}", lpc_reconstruct(*args),
                       lpc_reconstruct_ref(*args))
    return done


# The card's peaks for the bound (one H100 SXM at 700 W, from its
# published data sheet): HBM bytes per second, and the float32 rate
# outside the tensor cores, which the table's nearest to the 32- and
# 64-bit integer work of these kernels and, as an upper limit on their
# rate, keeps the bound a lower limit on their time.
HBM_BYTES_S = 3.35e12
OPS_S = 67e12
# Integer operations per output element of the kernels that are not a
# recurrence: rice16's bit extraction (shift, mask, leading zeros, the
# zigzag) and packtail's shift, decorrelation and pack.
OPS_PER_OUT = {"rice16": 8, "rice16_flat": 8, "packtail": 8}


def bound(name: str, inputs, out) -> tuple:
    """(the least time in ms the card could take for the call, "bytes"
    or "operations"): each tensor input read once (of packtail's stack,
    the rows its inv names) and the output written once at
    HBM_BYTES_S, against the call's operations at OPS_S. A recurrence
    over rows [B, n] with hist taps does a multiply and an add a tap, a
    shift and an add a step; the others OPS_PER_OUT a output
    element."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs
                 if isinstance(t, torch.Tensor))
    nbytes += out.numel() * out.element_size()
    if name == "packtail":
        # Only the stack rows that inv names need reading: the padded
        # frames of a decode_to_device chunk all name the dead row.
        stack, inv = inputs[0], inputs[1]
        used = torch.unique(inv.clamp(0, stack.shape[0] - 1)).numel()
        nbytes -= (stack.shape[0] - used) * stack.shape[1] * 4
    if name in OPS_PER_OUT:
        ops = OPS_PER_OUT[name] * out.numel()
    else:
        B, n = inputs[0].shape
        ops = B * n * (2 * inputs[1].shape[0] + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def path_times(name: str, chunks, line: str) -> None:
    """The kernels of a bench stream's decode_to_device path timed on
    each chunk that path reconstructs (the parallel scan's ranges):
    rice16 and, where the chunk takes it, packtail on the chunk (from a
    CUDA graph, graph_ms), and the LPC kernel on each LPC class of the
    chunk, in ns a step; for each kernel the sum per call against the
    sum of its bounds."""
    calls = {}
    for i, d in enumerate(chunks):
        g = d["geom"]
        calls.setdefault("rice16", []).append((
            f"chunk {i} NGp {g.NGp}", (d["win"], d["meta"]),
            lambda d=d, g=g: rice16_unpack_rows(d["win"], d["meta"],
                                                Ssort=g.Ssort)))
        if g.C == 2 and d["cb"] in (8, 16):
            calls.setdefault("packtail", []).append((
                f"chunk {i} Fp {g.Fp}", (d["stack"], *d["tail"]),
                lambda d=d, g=g: packtail(d["stack"], *d["tail"], Fp=g.Fp,
                                          container_bits=d["cb"])))
        for cname, args in d["lpc"].items():
            B, n = args[0].shape
            calls.setdefault(d["lpc_name"], []).append((
                f"chunk {i} {cname} [{B}, {n}]", args,
                lambda a=args, k=d["lpc_name"]: rt.LPC_KERNELS[k](*a)))
    for kernel, parts in calls.items():
        total = bnd = 0.0
        text = []
        for label, inputs, fn in parts:
            ms = graph_ms(fn) if kernel in STREAMING else cuda_ms(fn)
            b_ms, _ = bound(kernel, inputs, fn())
            total += ms
            bnd += b_ms
            step = (f" = {ms / inputs[0].shape[0] * 1e6:.1f} ns a step"
                    if kernel not in OPS_PER_OUT else
                    f" (bound {b_ms:.4f} ms)")
            text.append(f"{label} {ms:.4f} ms{step}")
        say("kernels", f"{kernel} on {name}'s decode_to_device chunks: "
            + "; ".join(text) + f"; {len(parts)} launches, {total:.4f} ms "
            f"a call against a bound of {bnd:.4f} ms ({100 * bnd / total:.1f} "
            f"% of it; median of {REPS} "
            f"{'graph replays' if kernel in STREAMING else 'batches'} each, "
            f"CUDA events) on {line}")


def compare_phase(csrc: str, ins: dict, path_ins: dict, line: str) -> None:
    """rice16 and packtail of another source tree (csrc, built by
    tools/kernel_ab.py) against this checkout's, on each bench stream's
    whole-stream chunk and on each chunk its decode_to_device
    reconstructs: equal outputs, then both timed from CUDA graphs in
    turns (other, this, this, other), and summed over each call's
    chunks against the summed bound."""
    lib = kernel_ab.load(csrc, os.path.join(_kernels.BUILD_DIR, "compare"))
    sums = {}
    for name in BENCH:
        for what, d in (("whole-stream chunk", ins[name]),
                        *((f"chunk {i}", c)
                          for i, c in enumerate(path_ins[name]))):
            g = d["geom"]
            pairs = {"rice16": (
                lambda d=d, g=g: kernel_ab.rice16(lib, d["win"], d["meta"],
                                                  g.Ssort),
                lambda d=d, g=g: rice16_unpack_rows(d["win"], d["meta"],
                                                    Ssort=g.Ssort),
                (d["win"], d["meta"]))}
            if g.C == 2 and d["cb"] in (8, 16):
                kw = dict(Fp=g.Fp, container_bits=d["cb"])
                pairs["packtail"] = (
                    lambda d=d, kw=kw: kernel_ab.packtail(
                        lib, d["stack"], *d["tail"], **kw),
                    lambda d=d, kw=kw: packtail(d["stack"], *d["tail"], **kw),
                    (d["stack"], *d["tail"]))
            for kernel, (other, this, inputs) in pairs.items():
                got, want = this(), other()
                if not torch.equal(got, want):
                    raise AssertionError(f"{kernel} on {name} {what}: this "
                                         f"build differs from {csrc}'s")
                t = [graph_ms(f) for f in (other, this, this, other)]
                b_ms, _ = bound(kernel, inputs, got)
                say("compare", f"{kernel} on {name} {what}: {csrc}'s "
                    f"{t[0]:.4f} / {t[3]:.4f} ms, this checkout's "
                    f"{t[1]:.4f} / {t[2]:.4f} ms (in turns, median of {REPS} "
                    f"graph replays each, CUDA events), bound {b_ms:.4f} ms, "
                    f"outputs equal; on {line}")
                if what.startswith("chunk"):
                    acc = sums.setdefault((name, kernel), [0.0, 0.0, 0.0, 0])
                    acc[0] += (t[0] + t[3]) / 2
                    acc[1] += (t[1] + t[2]) / 2
                    acc[2] += b_ms
                    acc[3] += 1
    for (name, kernel), (o, n, b, k) in sums.items():
        say("compare", f"{kernel} on {name}'s {k} decode_to_device chunks, "
            f"summed a call (mean of the two turns): {csrc}'s {o:.4f} ms, "
            f"this checkout's {n:.4f} ms, bound {b:.4f} ms "
            f"({100 * b / o:.1f} % / {100 * b / n:.1f} % of it); on {line}")


def hist32_inputs(dev) -> dict:
    """Seeded order-32 inputs at the bench widths, for the redesigned
    kernels at hist 32: lpc2w33 at bench32ms's class width, lpc at
    bench16's rows class, lpc64 at bench24's (label -> kernel
    arguments)."""
    rng = np.random.default_rng(32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = {}
    for label, n, bits in (("lpc2w33", 512, 33), ("lpc", 2048, 16),
                           ("lpc64", 1024, 33)):
        rows, cf, shift, order = hires_inputs(rng, n, BENCH_BLOCK, 32, bits)
        if label == "lpc2w33":
            args = (rows, cf)
        else:  # the rows engine's layout: row j for s[t-32+j]
            args = (rows.astype(np.int32 if label == "lpc" else np.int64),
                    np.ascontiguousarray(cf[::-1]))
        out[f"{label} hist 32 [{BENCH_BLOCK}, {n}]"] = (
            label, (t(args[0]), t(args[1]), t(shift), t(order)))
    return out


def extra_times(diff: Diff, hist32: dict, rows_ins: dict, safe_ins: dict,
                line: str) -> None:
    """lpc64 on bench32ms's rows class and bench16's safe_lpc class
    (beside bench24's, timed with the others), and the redesigned
    kernels on order-32 inputs (hist 32), checked against their plain
    versions first: kernel ms and ns a step against the bound."""
    for label, (name, args) in hist32.items():
        kern, plain = ring_fns(name)
        diff.check(name, label, kern(*args), plain(*args))
    cases = {"lpc64 bench32ms rows lpc": ("lpc64",
                                          rows_ins["bench32ms"]["lpc"]),
             "lpc64 bench16 safe_lpc rows lpc_wide": (
                 "lpc64", safe_ins["lpc_wide"]), **hist32}
    for label, (name, args) in cases.items():
        kern, _ = ring_fns(name)
        ms = cuda_ms(lambda: kern(*args))
        b_ms, by = bound(name, args, kern(*args))
        B, n = args[0].shape
        say("kernels", f"{label}: rows [{B}, {n}] {args[0].dtype}, hist "
            f"{hist_of(name, args[1])}, {ms:.4f} ms = {ms / B * 1e6:.1f} ns a step (median of {REPS} "
            f"batches, CUDA events), bound {b_ms:.4f} ms by {by}; on {line}")


def decode_check(what: str, data: bytes, want: np.ndarray,
                 **kw) -> object:
    """decode_to_device on the card; the host PCM (MD5 verified) and
    the device assembly must equal `want` and the native decoder."""
    dd = zflac_tpu_torch.decode_to_device(data, device="cuda", **kw)
    if dd is None:
        raise AssertionError(f"{what}: decode_to_device declined")
    host = dd.to_host()
    native, _ = decode_cpu_native(data)
    sh = fmt.normalization_shift(host.bits_per_sample)
    native = native << sh if sh else native
    dev = dd.interleaved_device().cpu().numpy().reshape(-1)
    for name, arr in (("to_host", host.interleaved),
                      ("interleaved_device", dev), ("native", native)):
        if not np.array_equal(arr, want):
            raise AssertionError(f"{what}: {name} differs from the "
                                 "encoder input")
    return dd


def e2e_times(data: bytes, n_samples: int, line: str, what: str) -> float:
    """decode_to_device end to end on `data`, synchronized, median of
    5 on the host clock, with its phase medians. Returns the median."""
    walls, phases = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a = time.perf_counter()
        dd = zflac_tpu_torch.decode_to_device(data, device="cuda")
        b = time.perf_counter()
        dd.synchronize()
        c = time.perf_counter()
        walls.append((c - a) * 1e3)
        phases.append(dict(dd.stats, wait_ms=(c - b) * 1e3))
    med = {k: statistics.median(p[k] for p in phases)
           for k in ("scan_ms", "rescan_ms", "enqueue_ms", "wait_ms")}
    e2e = statistics.median(walls)
    say("times", f"{what}: decode_to_device end to end (scan + H2D + "
        f"device, synchronized): {e2e:.3f} ms = "
        f"{n_samples / e2e / 1e3:.1f} Msamples/s, median of 5, host "
        f"clock, {phases[0]['chunks']} chunks, {os.cpu_count()} host "
        f"cores; phase medians (host clock) scan {med['scan_ms']:.3f} ms, "
        f"union re-scan {med['rescan_ms']:.3f} ms, upload + kernel "
        f"queueing {med['enqueue_ms']:.3f} ms, then waiting for the "
        f"device {med['wait_ms']:.3f} ms; on {line}")
    return e2e


def native_pcm(data: bytes) -> np.ndarray:
    """The native C++ decoder's output, normalized."""
    native, _ = decode_cpu_native(data)
    bps = parse_metadata(BitReader(data)).bits_per_sample
    sh = fmt.normalization_shift(bps)
    return native << sh if sh else native


def rows_decode_check(what: str, data: bytes, want: np.ndarray):
    """The rows engine on the card (MD5 verified inside decode) must
    equal `want` and the native decoder."""
    r = zflac_tpu_torch.decode(data, engine="torch", device="cuda")
    torch.cuda.synchronize()
    for name, arr in (("decode(engine=torch)", r.interleaved),
                      ("native", native_pcm(data))):
        if not np.array_equal(arr, want):
            raise AssertionError(f"{what}: {name} differs from the "
                                 "encoder input")
    return r


def rows_entry_points(benches: dict, corpus: dict) -> None:
    """decode_pipelined, stream_decode, decode_range and decode_tolerant
    on the card."""
    data16, want16 = benches["bench16"]
    r = zflac_tpu_torch.decode_pipelined(data16, chunk_frames=PIPE_FRAMES,
                                         device="cuda")
    if r.stats["chunks"] < 2 or not np.array_equal(r.interleaved, want16):
        raise AssertionError(f"decode_pipelined on bench16: {r.stats}, "
                             "PCM differs or one chunk")
    say("rows", f"decode_pipelined on bench16 (MD5 verified): "
        f"{r.stats['chunks']} chunks, bit-exact")

    data24, want24 = benches["bench24"]
    parts = list(zflac_tpu_torch.stream_decode(
        data24, chunk_frames=PIPE_FRAMES, device="cuda"))
    if len(parts) < 2 or not np.array_equal(np.concatenate(parts), want24):
        raise AssertionError("stream_decode on bench24: PCM differs or "
                             "one chunk")
    say("rows", f"stream_decode on bench24: {len(parts)} chunks, "
        "concatenation bit-exact")

    n16 = BENCH["bench16"][0]
    for start, count in ((0, 4096), (1234567, 100000),
                         (n16 - 5000, 10000)):
        r = zflac_tpu_torch.decode_range(data16, start, count,
                                         device="cuda")
        end = min(start + count, n16)
        if not np.array_equal(r.interleaved, want16[start * 2:end * 2]):
            raise AssertionError(f"decode_range({start}, {count}) on "
                                 "bench16 differs from the full decode")
    say("rows", "decode_range on bench16: three ranges equal the slices "
        "of the full decode")

    data = corpus["lpc order 8"][0]
    plan = build_plan(data)
    bad = bytearray(data)
    off = int(plan.frame_byte_offset[2]) + 40
    for i in range(8):
        bad[off + i] ^= 0xA5
    got = zflac_tpu_torch.decode_tolerant(bytes(bad), device="cuda")
    ref = zflac_tpu_torch.decode_tolerant(bytes(bad), device="cpu")
    if got.stats != ref.stats or got.stats["resyncs"] < 1 or \
            not np.array_equal(got.interleaved, ref.interleaved):
        raise AssertionError(f"decode_tolerant: card {got.stats} vs CPU "
                             f"{ref.stats}")
    say("rows", f"decode_tolerant on 'lpc order 8' with frame 2 "
        f"corrupted: {got.stats}, PCM equal to the same call on the CPU")


def rows_times(data: bytes, n_samples: int, line: str, what: str) -> None:
    """decode(engine="torch") end to end on `data`, median of 5 on the
    host clock; then its phases, median of 5, from a phased run of the
    same steps (runtime/decode.py) with a synchronize after the
    launches."""
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        a = time.perf_counter()
        zflac_tpu_torch.decode(data, engine="torch", device="cuda")
        walls.append((time.perf_counter() - a) * 1e3)
    names = ("plan build", "padding and packing", "H2D + enqueue",
             "device wait", "D2H + assembly", "MD5 + normalization")
    phases = []
    for _ in range(5):
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
        out = rd._assemble(plan, pcm[:plan.num_frames].cpu().numpy())
        ts.append(time.perf_counter())
        rd._finish(out, plan.info.bits_per_sample, plan.info.md5, True)
        ts.append(time.perf_counter())
        phases.append([(b - a) * 1e3 for a, b in zip(ts, ts[1:])])
    med = [statistics.median(p[i] for p in phases)
           for i in range(len(names))]
    e2e = statistics.median(walls)
    say("times", f"{what}: decode(engine=\"torch\") end to end (host "
        f"PCM, MD5 verified): {e2e:.3f} ms = "
        f"{n_samples / e2e / 1e3:.1f} Msamples/s, median of 5, host "
        f"clock, {os.cpu_count()} host cores; phase medians (host clock, "
        f"phased run) " + ", ".join(
            f"{n} {m:.3f} ms" for n, m in zip(names, med))
        + f" (sum {sum(med):.3f} ms); on {line}")


# ---------------------------------------------------------------------
# Phases 8-13: the faults repaired, and the multi-device, multi-process
# and command-line paths.
# ---------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# Seconds a worker, CLI or profile subprocess may take (each starts
# Python, loads torch and the libraries and reaches the card).
PROC_TIMEOUT = 300
# Frames a chunk in the sharded decode's multi-round case.
ROUND_FRAMES = 32
# The device the worker, CLI and profile processes decode on.
CARD = "cuda:0"
PORT_KERNELS = ("rice16_rows_kernel", "lpc2_kernel", "lpc2w_kernel",
                "lpc2w33_kernel", "lpc_kernel", "packtail_kernel")


def same_empty(what: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or \
            got.device != want.device or got.numel():
        raise AssertionError(
            f"{what}: kernel route {tuple(got.shape)} {got.dtype} on "
            f"{got.device}, plain version {tuple(want.shape)} {want.dtype}")


def faults_phase(dev, benches: dict) -> None:
    """Empty shapes through every wrapper on the card; the thread's
    current CUDA device after decodes."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    _kernels.launches.clear()
    n_cases = 0
    for B, n in ((0, 128), (128, 0), (0, 0)):
        for name, dtype in (("lpc2", torch.int32), ("lpc2w", torch.int32),
                            ("lpc2w33", torch.int64)):
            args = (z(B, n, dtype=dtype), z(8, n), z(n), z(n))
            same_empty(f"{name} B={B} n={n}", rt.LPC_KERNELS[name](*args),
                       LPC_PLAIN[name](*args))
            n_cases += 1
        for dtype in (torch.int32, torch.int64):
            args = (z(B, n, dtype=dtype), z(32, n), z(n), z(n))
            same_empty(f"{LPC_ROWS_KERNEL[dtype]} B={B} n={n}",
                       lpc_reconstruct(*args), lpc_reconstruct_ref(*args))
            n_cases += 1
    for W in (8, 16):
        same_empty(f"rice16 W={W} NGp=0",
                   rice16_unpack_rows(z(W, 0), z(0), Ssort=512),
                   rice16_unpack_rows_ref(z(W, 0), z(0), Ssort=512))
        same_empty(f"rice16_flat W={W} NG=0", rice16_unpack(z(W, 0), z(0)),
                   rice16_unpack_ref(z(W, 0), z(0)))
        n_cases += 2
    for cb in (16, 8):
        args = (z(3, 128), z(0), z(0), z(0))
        same_empty(f"packtail Fp=0 container {cb}",
                   packtail(*args, Fp=0, container_bits=cb),
                   packtail_ref(*args, Fp=0, container_bits=cb))
        n_cases += 1
    torch.cuda.synchronize()
    if sum(_kernels.launches.values()):
        raise AssertionError(f"empty shapes launched kernels: "
                             f"{dict(_kernels.launches)}")
    say("faults", f"{n_cases} empty shapes (B == 0, n == 0, NGp == 0, "
        "Fp == 0) through all eight wrappers on the card: the plain "
        "versions' empty results, no launch")

    data, want = benches["bench16"]
    before = torch.cuda.current_device()
    decode_check("faults bench16", data, want)
    rows_decode_check("faults bench16", data, want)
    if torch.cuda.current_device() != before:
        raise AssertionError(
            f"a decode moved the thread's CUDA device from {before} to "
            f"{torch.cuda.current_device()}")
    say("faults", f"torch.cuda.current_device() is {before} before and "
        "after decode_to_device and decode(engine=\"torch\") on bench16")
    if torch.cuda.device_count() < 2:
        say("faults", "a decode on cuda:1 from a thread on cuda:0: did not "
            "run, the host has one card")
        return
    torch.cuda.set_device(0)
    dd0 = zflac_tpu_torch.decode_to_device(data, device="cuda:0")
    dd1 = zflac_tpu_torch.decode_to_device(data, device="cuda:1")
    r1 = zflac_tpu_torch.decode(data, engine="torch", device="cuda:1")
    if torch.cuda.current_device() != 0:
        raise AssertionError("a decode on cuda:1 left the thread on "
                             f"cuda:{torch.cuda.current_device()}")
    if dd1.chunks[0].device != torch.device("cuda", 1) or not (
            np.array_equal(dd1.to_host().interleaved, want)
            and np.array_equal(dd0.to_host().interleaved, want)
            and np.array_equal(r1.interleaved, want)):
        raise AssertionError("decode on cuda:1 differs from cuda:0")
    say("faults", "decodes on cuda:1 from a thread on cuda:0 (both "
        "engines): the thread stays on cuda:0, PCM equal to cuda:0's")


def sync_mesh(mesh) -> None:
    for d in set(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def md5_domain(want: np.ndarray, bps: int) -> np.ndarray:
    """Normalized container samples back in the MD5 domain."""
    shift = fmt.normalization_shift(bps)
    return want >> shift if shift else want


def sharded_decode_check(diff: Diff, what: str, data: bytes,
                         want: np.ndarray, mesh, **kw) -> tuple:
    """decode_to_device_sharded on the mesh with the counters reset
    before and read after: host PCM equal to the encoder's input, MD5
    verified, completeness count equal to the block sizes, and each
    kernel launched once per live chunk and class; then each kernel
    against its plain version on every chunk of the call, on the
    chunk's device. Returns (meta, the launch counts, the first chunk's
    geometry)."""
    _kernels.launches.clear()
    r = decode_to_device_sharded(data, mesh, **kw)
    if r is None:
        raise AssertionError(f"{what}: decode_to_device_sharded declined")
    out, meta = r
    sync_mesh(mesh)
    got = dict(_kernels.launches)
    bps, C = meta["bits_per_sample"], meta["channels"]
    for rnd in out:
        if [t.device for t in rnd] != list(mesh):
            raise AssertionError(f"{what}: a round's tensors are not on "
                                 "the mesh's devices in order")
    host = sharded_to_host(out, meta)
    if not np.array_equal(host, md5_domain(want, bps)):
        raise AssertionError(f"{what}: sharded_to_host differs from the "
                             "encoder input")
    if not rt.verify_stream_md5(host, bps, meta["md5"]):
        raise AssertionError(f"{what}: stream MD5 mismatch")
    samples = C * sum(int(b.sum()) for b in meta["block_sizes"])
    if int(meta["psum_samples"]) != samples or \
            meta["psum_samples"].device != mesh[0]:
        raise AssertionError(
            f"{what}: completeness count {int(meta['psum_samples'])} on "
            f"{meta['psum_samples'].device}, block sizes give {samples}")
    # The chunks the call reconstructed: the same scan at its chunk
    # size, which is the frame axis of its tensors.
    br = BitReader(data)
    info = parse_metadata(br)
    cks = rt.stream_chunks(data, info, br.pos // 8,
                           chunk_frames=out[0][0].shape[0])
    live = len(meta["num_frames"])
    if len(cks) != live or meta["rounds"] != -(-live // len(mesh)):
        raise AssertionError(f"{what}: {live} chunks in {meta['rounds']} "
                             f"rounds, the scan gives {len(cks)}")
    geom = rt.Pack2Geom.of(cks[0])
    cb = fmt.container_bits(bps)
    expect = {"rice16": live,
              rt.lpc_kernel(geom, cb): live * sum(
                  name.startswith("lpc") for name, _ in geom.classes)}
    if C == 2 and cb in (8, 16):
        expect["packtail"] = live
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect} "
                             f"({live} live chunks of classes "
                             f"{geom.classes})")
    for i, ck in enumerate(cks):
        kernel_checks(mesh[i % len(mesh)], diff,
                      f"{what} sharded chunk {i}", ck)
    return meta, got, geom


def geom_line(g) -> str:
    return (f"Fp {g.Fp}, Bp {g.Bp}, Ssort {g.Ssort}, W {g.W}, NGp {g.NGp}, "
            f"classes {g.classes}")


def sharded_phase(diff: Diff, benches: dict, mesh, single_ms: dict,
                  line: str, launches: dict) -> None:
    D = len(mesh)
    where = (f"{D} cards" if len(set(mesh)) > 1
             else f"{D} slots on {mesh[0]}")
    for name, (data, want) in benches.items():
        meta, got, g = sharded_decode_check(diff, name, data, want, mesh)
        say("sharded", f"{name}: decode_to_device_sharded over {where} -> "
            f"sharded_to_host (MD5 verified) == encoder input; "
            f"{len(meta['num_frames'])} chunks of {meta['num_frames']} "
            f"frames in {meta['rounds']} rounds; completeness count "
            f"{int(meta['psum_samples'])} == channels x block sizes; "
            f"kernel launches {got}; every kernel == its plain version on "
            f"each chunk ({geom_line(g)})")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    meta, got, g = sharded_decode_check(
        diff, f"bench16, chunk_frames={ROUND_FRAMES}", *benches["bench16"],
        mesh, chunk_frames=ROUND_FRAMES)
    if meta["rounds"] < 3:
        raise AssertionError(f"chunk_frames={ROUND_FRAMES} gave "
                             f"{meta['rounds']} rounds")
    say("sharded", f"bench16 in {len(meta['num_frames'])} chunks of "
        f"{ROUND_FRAMES} frames, {meta['rounds']} rounds over {where}: "
        f"bit-exact, launches {got}; every kernel == its plain version on "
        f"each chunk ({geom_line(g)})")

    for name, (data, _) in benches.items():
        plan = build_plan(data)
        _kernels.launches.clear()
        pcm, total = reconstruct_sharded(plan, mesh)
        got = dict(_kernels.launches)
        single = rd._run_reconstruct(plan, mesh[0])
        kernel = ROWS_PATH[name][0]
        if not np.array_equal(pcm, single[:, :pcm.shape[1]]) or \
                got != {kernel: D}:
            raise AssertionError(f"reconstruct_sharded on {name}: PCM "
                                 f"differs or launches {got}")
        F_loc = -(-plan.num_frames // D)
        if total != F_loc * D * pcm.shape[1]:
            raise AssertionError(f"reconstruct_sharded on {name}: total "
                                 f"{total}")
        # lpc / lpc64 on each device's slice as _local_reconstruct gets
        # it: a share of the lanes, sentinel-padded class lists.
        arrays, smeta = shard_plan(plan, D)
        shapes = set()
        for d, device in enumerate(mesh):
            t = local_arrays(arrays, smeta, d, device)
            for args in class_lpc_checks(
                    diff, f"{name} reconstruct_sharded device {d}", t,
                    {cls: t[key] for key, cls in (("idx_lpc", "lpc"),
                                                  ("idx_lpc_wide", "lpc_wide"))
                     if key in t}).values():
                shapes.add(f"{list(args[0].shape)} {args[0].dtype}")
        say("sharded", f"{name}: reconstruct_sharded of the rows plan over "
            f"{where} == _run_reconstruct on one device, PCM "
            f"{list(pcm.shape)}, total {total}; kernel launches {got}; "
            f"{kernel} == its plain version on each device's slice, rows "
            f"{sorted(shapes)}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # Host-clock times drift over a run, so the two calls alternate.
    for name in ("bench16", "bench24"):
        data = benches[name][0]
        walls, ones = [], []
        for _ in range(5):
            sync_mesh(mesh)
            a = time.perf_counter()
            decode_to_device_sharded(data, mesh)
            sync_mesh(mesh)
            b = time.perf_counter()
            zflac_tpu_torch.decode_to_device(data, device=mesh[0]
                                             ).synchronize()
            walls.append((b - a) * 1e3)
            ones.append((time.perf_counter() - b) * 1e3)
        med = statistics.median(walls)
        say("times", f"{name}: decode_to_device_sharded over {where} end "
            f"to end (scan + H2D + device, synchronized): {med:.3f} ms = "
            f"{BENCH[name][0] * 2 / med / 1e3:.1f} Msamples/s, median of "
            f"5, host clock (runs {', '.join(f'{w:.3f}' for w in walls)}); "
            f"decode_to_device on {mesh[0]}, each run just after a sharded "
            f"one: {statistics.median(ones):.3f} ms (runs "
            f"{', '.join(f'{w:.3f}' for w in ones)}), and earlier in this "
            f"run: {single_ms[name]:.3f} ms; {torch.cuda.device_count()} "
            f"card(s) on the host, {os.cpu_count()} host cores; on {line}")


def shard_lpc_checks(diff: Diff, what: str, data: bytes, num_shards: int,
                     mesh) -> list:
    """lpc / lpc64 against their plain version on the plan of each
    byte-range shard of the stream, on the shard's device. Returns the
    rows' shapes."""
    _, shards = shard_index(data, num_shards)
    return [f"{list(a[0].shape)} {a[0].dtype}"
            for h, (_, _, plan) in enumerate(shards)
            for a in rows_lpc_checks(mesh[h % len(mesh)], diff,
                                     f"{what} shard {h}", plan).values()]


def longstream_phase(diff: Diff, benches: dict, mesh, line: str,
                     launches: dict) -> None:
    for name in ("bench16", "bench24"):
        data, want = benches[name]
        shapes = shard_lpc_checks(diff, f"{name} decode_longstream", data, 4,
                                  mesh)
        _kernels.launches.clear()
        r = decode_longstream(data, 4, mesh)
        got = dict(_kernels.launches)
        if not np.array_equal(r.interleaved, want) or \
                got != {ROWS_PATH[name][0]: r.stats["shards"]}:
            raise AssertionError(f"decode_longstream on {name}: "
                                 f"{r.stats}, launches {got}, or PCM differs")
        walls = []
        for _ in range(3):
            a = time.perf_counter()
            decode_longstream(data, 4, mesh)
            walls.append((time.perf_counter() - a) * 1e3)
        say("longstream", f"{name}: decode_longstream in 4 shards over "
            f"{len(mesh)} mesh slots (MD5 verified) == encoder input; "
            f"{r.stats}; kernel launches {got}; {ROWS_PATH[name][0]} == its "
            f"plain version on each shard's plan, rows {shapes}; "
            f"{statistics.median(walls):.3f} ms end to end (host PCM), "
            f"median of 3, host clock; on {line}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v


def run_procs(what: str, cmds: list, env: dict = None) -> list:
    """Run the commands at once from the checkout's root; returns their
    outputs. A non-zero return code or a timeout raises, and no process
    is left running."""
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: {' '.join(c)} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return outs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def distributed_phase(diff: Diff, data: bytes, want: np.ndarray, tmp: str,
                      line: str) -> None:
    """Two worker processes sharing one card decode bench16 together,
    through the pack2 path and through the long-stream path; each
    prints its launch counts, which must be those of its one chunk (or
    its one shard). Before that, each kernel is held against its plain
    version here on the chunks and shard plans the workers make."""
    dev = torch.device(CARD)
    # Outside any process group, two local ranges are the two workers'
    # ranges, and the union over them is the union the workers gather.
    br = BitReader(data)
    info = parse_metadata(br)
    _, cks = union_chunks(data, info, br.pos // 8, 2)
    if cks is None or len(cks) != 2:
        raise AssertionError("distributed: the two ranges' pack2 scan "
                             "declined")
    for i, ck in enumerate(cks):
        kernel_checks(dev, diff, f"bench16 worker {i} pack2 chunk", ck)
    g = rt.Pack2Geom.of(cks[0])
    cb = fmt.container_bits(info.bits_per_sample)
    expect = {"pack2": {"rice16": 1, "packtail": 1,
                        rt.lpc_kernel(g, cb): sum(
                            n.startswith("lpc") for n, _ in g.classes)},
              "longstream": {"lpc": 1}}
    shapes = shard_lpc_checks(diff, "bench16 worker", data, 2, [dev])
    say("distributed", f"every kernel == its plain version on the two "
        f"workers' pack2 chunks ({geom_line(g)}) and lpc on their "
        f"long-stream plans, rows {shapes}")

    for engine in ("pack2", "longstream"):
        outs = [os.path.join(tmp, f"{engine}{rank}.npy") for rank in (0, 1)]
        coordinator = f"127.0.0.1:{free_port()}"
        a = time.perf_counter()
        logs = run_procs(f"distributed {engine}", [
            [sys.executable, "-m", "zflac_tpu_torch.parallel.distributed",
             bench_path("bench16"), out, coordinator, str(rank), "2", engine,
             CARD] for rank, out in enumerate(outs)])
        wall = time.perf_counter() - a
        for out in outs:
            if not np.array_equal(np.load(out), want):
                raise AssertionError(f"distributed {engine}: {out} differs "
                                     "from the encoder input")
        stats = [log.strip().splitlines()[-1] for log in logs]
        if not all(f"'engine': '{engine}-distributed'" in s_ and
                   "'processes': 2" in s_ for s_ in stats):
            raise AssertionError(f"distributed {engine}: {stats}")
        counts = [ast.literal_eval(s_.split("kernel launches ")[1])
                  for s_ in stats]
        if counts != [expect[engine]] * 2:
            raise AssertionError(f"distributed {engine}: the workers "
                                 f"launched {counts}, expected "
                                 f"{expect[engine]} each")
        say("distributed", f"bench16, {engine}: 2 processes on {CARD} over "
            f"gloo, both outputs == encoder input; {stats[0]} in each "
            f"process; {wall:.1f} s "
            f"from start to exit of both processes (host clock, Python "
            f"and CUDA start-up included); on {line}")


def cli_and_profile_phase(want: np.ndarray, tmp: str, line: str) -> None:
    """The command line's decode, verify and bench on bench16, and a
    decode under ZFLAC_TPU_PROFILE, as four processes at once."""
    path = bench_path("bench16")
    wav = os.path.join(tmp, "x.wav")
    traces = os.path.join(tmp, "traces")
    cmd = [sys.executable, "-m", "zflac_tpu_torch.cli"]
    procs = {
        "decode": [*cmd, "decode", path, "-o", wav, "--device", CARD],
        "verify": [*cmd, "verify", path, "--device", CARD],
        "bench": [*cmd, "bench", path, "--reps", "3", "--device", CARD],
    }
    outs = dict(zip(procs, run_procs("cli", list(procs.values()))))
    with open(wav, "rb") as f:
        riff = f.read()
    if riff[:4] != b"RIFF" or riff[44:] != want.tobytes():
        raise AssertionError("cli decode: the WAV's payload differs from "
                             "the encoder input")
    if "OK: MD5 verified" not in outs["verify"] or \
            f"wrote {wav}" not in outs["decode"]:
        raise AssertionError(f"cli: {outs}")
    bench = json.loads(outs["bench"].strip().splitlines()[-1])
    if bench["frames"] != BENCH["bench16"][0] // BENCH_BLOCK or \
            not bench["median_ms"] > 0:
        raise AssertionError(f"cli bench: {bench}")
    say("cli", f"decode -o x.wav (payload == encoder input): "
        f"{outs['decode'].splitlines()[0]}; verify: "
        f"{outs['verify'].strip()}; bench --reps 3: {bench} (three CLI "
        f"processes on the card at once); on {line}")

    # The same command in this process, where the launches can be read.
    _kernels.launches.clear()
    rc = cli.main(["verify", path, "--device", CARD])
    got = dict(_kernels.launches)
    if rc != 0 or got != {"lpc": 1}:
        raise AssertionError(f"cli verify in this process: return code {rc}, "
                             f"launches {got}")
    say("cli", f"verify through cli.main in this process: return code 0, "
        f"kernel launches {got}")

    code = ("import sys, zflac_tpu_torch\n"
            "r = zflac_tpu_torch.decode(sys.argv[1], device=sys.argv[2])\n"
            "print(r.stats)\n")
    run_procs("profile", [[sys.executable, "-c", code, path, CARD]],
              env={"ZFLAC_TPU_PROFILE": traces})
    files = os.listdir(traces)
    if len(files) != 1:
        raise AssertionError(f"profile: trace files {files}")
    with open(os.path.join(traces, files[0])) as f:
        text = f.read()
    found = [k for k in PORT_KERNELS if k in text]
    if "zflac_tpu_torch.decode" not in text or not found:
        raise AssertionError(
            f"profile: {files[0]} ({len(text)} B) holds the label: "
            f"{'zflac_tpu_torch.decode' in text}, kernels: {found}")
    say("profile", f"decode of bench16 under ZFLAC_TPU_PROFILE: "
        f"{files[0]} ({len(text)} B) holds the label "
        f"zflac_tpu_torch.decode and the kernels {found}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare-csrc", metavar="CSRC",
                    help="also time another source tree's rice16 and "
                    "packtail beside this checkout's (compare_phase)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        sys.exit(1)

    dev = torch.device("cuda", 0)
    line = gpu_line()
    say("device", f"{line} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # The bench streams encode in worker processes (minutes of host
    # work, cached afterwards) while the kernels build.
    t_streams = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=len(BENCH),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = {name: pool.submit(bench_stream, name) for name in BENCH}
        # The CUDA kernels (one nvcc per source) and the host scan
        # library build at the same time, from the checkout's sources.
        with ThreadPoolExecutor(2) as ex:
            k_s = ex.submit(seconds, lambda: _kernels.build(force=True))
            n_s = ex.submit(seconds,
                            lambda: native_indexer.build(force=True))
            k_s, n_s = k_s.result(), n_s.result()
        _kernels.library()
        if not native_indexer.native_available():
            raise RuntimeError("the native scan library did not load")
        say("build", f"CUDA kernels {k_s:.1f} s (nvcc "
            f"{_kernels.find_nvcc()}, {' '.join(_kernels.NVCC_FLAGS)}, "
            f"one process per source), host scan library {n_s:.1f} s "
            f"(g++ {' '.join(native_indexer.CXX_FLAGS)} into "
            f"{os.path.relpath(native_indexer.BUILD_DIR)}), at once")
        for line_ in ptxas_summary():
            say("build", line_)
        corpus = {name: (data, expected_pcm(pcm, bps))
                  for name, (data, pcm, _sr, bps) in make_corpus().items()}
        benches = {name: (fut.result(),
                          expected_pcm(bench_pcm(name), BENCH[name][1]))
                   for name, fut in pending.items()}
    say("streams", ", ".join(
        f"{name} {len(data)} B ({BENCH[name][0]} x 2 samples, "
        f"{BENCH[name][1]}-bit)" for name, (data, _) in benches.items())
        + f" and {len(corpus)} corpus streams, "
        f"{time.perf_counter() - t_streams:.1f} s")

    # ---- kernels against their plain versions, on the card ----
    diff = Diff()
    ins, path_ins = {}, {}
    for name, (data, _) in benches.items():
        ins[name] = kernel_checks(dev, diff, f"{name} chunk",
                                  first_chunk(data))
        # The chunks decode_to_device itself reconstructs: one per
        # anchor-split range of the parallel scan, in their union
        # geometry.
        br = BitReader(data)
        cks = rt.stream_chunks(data, parse_metadata(br), br.pos // 8)
        path_ins[name] = [kernel_checks(dev, diff,
                                        f"{name} path chunk {i}", ck)
                          for i, ck in enumerate(cks)]
    for name, (data, _) in corpus.items():
        kernel_checks(dev, diff, name, first_chunk(data))
    rows_ins = {name: rows_lpc_checks(dev, diff, f"{name} rows plan",
                                      build_plan(data))
                for name, (data, _) in benches.items()}
    safe_ins = rows_lpc_checks(dev, diff, "bench16 safe_lpc rows plan",
                               build_plan(benches["bench16"][0]),
                               safe_lpc=True)
    for name, (data, _) in corpus.items():
        rows_lpc_checks(dev, diff, f"{name} rows plan", build_plan(data))
    # The streaming kernels' synthetic inputs at the bench chunks'
    # shapes: each stream's whole-stream chunk and first path chunk.
    firsts = [(d["geom"], d["cb"]) for name in BENCH
              for d in (ins[name], path_ins[name][0])]
    streamed = synthetic_checks(
        dev, diff, sorted({(g.W, g.Ssort, g.NGp // g.Ssort)
                           for g, _ in firsts}),
        sorted({(g.Fp, g.Bp) for g, cb in firsts
                if g.C == 2 and cb in (8, 16)}))
    torch.cuda.synchronize()
    for name, d in ins.items():
        g = d["geom"]
        say("kernels", f"{name} whole-stream chunk: Fp {g.Fp}, Bp {g.Bp}, "
            f"Ssort {g.Ssort}, W {g.W}, NGp {g.NGp}, wide {g.wide}, "
            f"classes {g.classes}, LPC kernel {d['lpc_name']}; "
            f"decode_to_device reconstructs {len(path_ins[name])} "
            f"parallel-scan chunks of classes "
            f"{path_ins[name][0]['geom'].classes}")
    for name, cls in rows_ins.items():
        say("kernels", f"{name} rows-engine plan: LPC classes " + ", ".join(
            f"{c} rows {list(a[0].shape)} {a[0].dtype}"
            for c, a in cls.items()))
    say("kernels", f"rice16, rice16_flat and packtail bit-exact on seeded "
        f"inputs: {'; '.join(streamed)} (rice16 also with win and meta, "
        f"packtail with the stack, at an odd offset)")
    say("kernels", f"bit-exact on the bench chunks, their parallel-scan "
        f"chunks, {len(corpus)} corpus chunks, the rows-engine plans of "
        f"the bench and corpus streams and synthetic inputs; max |err| "
        f"{diff.err}")

    # Each kernel is timed on the first LPC class (lpc8 in all three) of
    # the bench chunk whose path runs it.
    timed_on = {"lpc2w": "bench24", "lpc2w33": "bench32ms"}
    b16 = ins["bench16"]
    win, meta, Ss = b16["win"], b16["meta"], b16["geom"].Ssort
    tail = (b16["stack"], *b16["tail"])
    tkw = dict(Fp=b16["geom"].Fp, container_bits=b16["cb"])
    lpc_args = {k: next(iter(ins[timed_on.get(k, "bench16")]["lpc"].values()))
                for k in LPC_PLAIN}
    timed = {
        "rice16": (lambda: rice16_unpack_rows(win, meta, Ssort=Ss),
                   lambda: rice16_unpack_rows_ref(win, meta, Ssort=Ss)),
        "rice16_flat": (lambda: rice16_unpack(win, meta),
                        lambda: rice16_unpack_ref(win, meta)),
        "packtail": (lambda: packtail(*tail, **tkw),
                     lambda: packtail_ref(*tail, **tkw)),
    }
    for k, a in lpc_args.items():
        timed[k] = (lambda k=k, a=a: rt.LPC_KERNELS[k](*a),
                    lambda k=k, a=a: LPC_PLAIN[k](*a))
    # lpc and lpc64 on the lpc class of bench16's and bench24's
    # rows-engine plans.
    timed_on.update(lpc="bench16 rows", lpc64="bench24 rows")
    lpc_args["lpc"] = rows_ins["bench16"]["lpc"]
    lpc_args["lpc64"] = rows_ins["bench24"]["lpc"]
    for k in ("lpc", "lpc64"):
        timed[k] = (lambda a=lpc_args[k]: lpc_reconstruct(*a),
                    lambda a=lpc_args[k]: lpc_reconstruct_ref(*a))
    # The tensor inputs of each timed call, for its bound.
    timed_in = dict(lpc_args, rice16=(win, meta), rice16_flat=(win, meta),
                    packtail=tail)
    times, bounds = {}, {}
    for name in KERNELS:
        kern, plain = timed[name]
        plain_reps = PLAIN_LPC_REPS if name in ("lpc", "lpc64") else REPS
        times[name] = (graph_ms(kern) if name in STREAMING else cuda_ms(kern),
                       cuda_ms(plain, plain_reps))
        bounds[name] = bound(name, timed_in[name], kern())
        where = timed_on.get(name, "bench16")
        shape = ""
        if name in STREAMING:
            shape = (f" (from a CUDA graph of 20 calls; back to back from "
                     f"Python {cuda_ms(kern):.4f} ms, which is the host's "
                     f"issue time where it exceeds the kernel's)")
        if name in lpc_args:
            B, n = lpc_args[name][0].shape
            shape = (f" (rows [{B}, {n}] {lpc_args[name][0].dtype}, hist "
                     f"{hist_of(name, lpc_args[name][1])}: "
                     f"{times[name][0] / B * 1e6:.1f} ns per step)")
        say("kernels", f"{name} at {where} shapes{shape}: kernel "
            f"{times[name][0]:.4f} ms (median of {REPS} "
            f"{'replays' if name in STREAMING else 'batches'}), plain "
            f"PyTorch {times[name][1]:.4f} ms (median of {plain_reps} "
            f"batches); per call, CUDA events; bound "
            f"{bounds[name][0]:.4f} ms by {bounds[name][1]} "
            f"({100 * bounds[name][0] / times[name][0]:.1f} % of it); on "
            f"{line}")
    extra_times(diff, hist32_inputs(dev), rows_ins, safe_ins, line)
    for name in BENCH:
        path_times(name, path_ins[name], line)
    if args.compare_csrc:
        compare_phase(args.compare_csrc, ins, path_ins, line)

    # ---- the main path, counted: each bench stream's own run ----
    launches = {}
    for name, (data, want) in benches.items():
        _kernels.launches.clear()
        dd = decode_check(name, data, want)
        torch.cuda.synchronize()
        got = dict(_kernels.launches)
        say("slice", f"{name}: decode_to_device -> to_host (MD5 verified) "
            f"== encoder input == native decoder; chunks "
            f"{len(dd.chunks)}, frames {dd.stats['frames']}; kernel "
            f"launches {got}")
        missing = [k for k in BENCH[name][3] if not got.get(k)]
        if missing:
            raise AssertionError(f"kernels not launched on the {name} "
                                 f"path: {missing}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # ---- the rows engine's main path, counted per bench stream ----
    for name, (data, want) in benches.items():
        _kernels.launches.clear()
        r = rows_decode_check(name, data, want)
        got = dict(_kernels.launches)
        say("rows", f"{name}: decode(engine=\"torch\", device=\"cuda\") "
            f"(MD5 verified) == encoder input == native decoder; frames "
            f"{r.stats['frames']}; kernel launches {got}")
        missing = [k for k in ROWS_PATH[name] if not got.get(k)]
        if missing:
            raise AssertionError(f"kernels not launched on the {name} "
                                 f"rows-engine path: {missing}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, (data, want) in corpus.items():
        decode_check(name, data, want)
        rows_decode_check(name, data, want)
    say("slice", f"{len(corpus)} corpus streams bit-exact through both "
        "engines (decode_to_device: to_host with MD5, interleaved_device; "
        "decode(engine=\"torch\") with MD5; native decoder)")
    rows_entry_points(benches, corpus)
    dd4 = decode_check("bench16, chunk_frames=256", *benches["bench16"],
                       chunk_frames=256)
    if len(dd4.chunks) < 2:
        raise AssertionError("chunk_frames=256 gave one chunk")
    say("slice", f"bench16 in {len(dd4.chunks)} chunks bit-exact")
    bad = bytearray(corpus["lpc order 8"][0])
    bad[-200] ^= 0x10
    dd_bad = zflac_tpu_torch.decode_to_device(bytes(bad), device="cuda")
    if dd_bad is None:
        raise AssertionError("corrupted stream declined; expected a decode "
                             "that fails its MD5")
    try:
        dd_bad.to_host()
    except InvalidChecksum as e:
        say("slice", f"corrupted stream raises InvalidChecksum ({e})")
    else:
        raise AssertionError("corrupted stream decoded without an MD5 error")

    # ---- times ----
    for name, d in ins.items():
        n_samples = BENCH[name][0] * 2
        rec_ms = cuda_ms(lambda d=d: rt.reconstruct_pack2(
            d["buf"], d["geom"], container_bits=d["cb"]))
        say("times", f"reconstruct_pack2, {name} whole-stream chunk from a "
            f"device buffer: {rec_ms:.4f} ms = "
            f"{n_samples / rec_ms / 1e3:.1f} Msamples/s (both channels; "
            f"per call, median of {REPS} batches, CUDA events) on {line}")
    single_ms = {name: e2e_times(benches[name][0], BENCH[name][0] * 2,
                                 line, name)
                 for name in ("bench16", "bench24")}
    for name in ("bench16", "bench24"):
        rows_times(benches[name][0], BENCH[name][0] * 2, line, name)

    # ---- the faults repaired; the multi-device, multi-process and
    # command-line paths ----
    faults_phase(dev, benches)
    mesh = make_mesh() if torch.cuda.device_count() > 1 \
        else make_mesh(["cuda:0"] * 4)
    sharded_phase(diff, benches, mesh, single_ms, line, launches)
    longstream_phase(diff, benches, mesh, line, launches)
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        distributed_phase(diff, *benches["bench16"], tmp, line)
        cli_and_profile_phase(benches["bench16"][1], tmp, line)
    say("device", f"{torch.cuda.device_count()} card(s) on the host; total "
        f"{time.perf_counter() - t_streams:.0f} s since the build began")

    records = [{"name": k, "route": "cuda", "source": src,
                "replaces": rep, "launches": int(launches.get(k, 0)),
                "max_abs_err": diff.err[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": None}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": records}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
