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
     mid-side, whose 33-bit side channels make wide chunks), bench16_513
     (bench16 cut to 513 frames, one past a power of two, for the rows
     engine), bench16_track (bench16's signal at a 3 min 30 s track's
     length, 2261 frames, whose decode_to_device chunks of 282-283
     frames are not near a power of two) and every corpus stream;
  4. holds each kernel bit for bit against its plain PyTorch version on
     the card: rice16, rice16_flat, lpc2, packtail, lpc2w and lpc2w33 on
     every stream's real pack2 chunk sections in the card layout that
     decode_to_device reconstructs (bench16_track's 8 chunks, corpus
     chunks whose Bp is no multiple of 128 and of several classes, and
     three_class_stream, whose LPC class starts at lane 64, among
     them), lpc and lpc64 on the LPC
     classes of every stream's rows-engine plan (gathered as the rows
     engine gathers them, the safe_lpc plans of bench16 and bench16_513
     too, and classes of 1, 7, 33 and 1026 members padded to a multiple
     of 32 lanes as pad_plan pads them), the rows engine's fixed
     class as lanes of lpc / lpc64 (every plan's launch that holds it
     against its plain version and its fixed lanes against
     fixed_integrate, seeded fixed lanes of orders 0-4 at B 4096 against
     the samples, and no torch.cumsum kernel under torch.profiler), and
     all of them on seeded synthetic inputs (rice16, rice16_flat and packtail
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
     lpc and lpc64 on bench16_513's classes (n 1056), the redesigned
     kernels at hist 32, and rice16, packtail and the LPC
     kernel on each chunk decode_to_device reconstructs for bench16,
     bench24, bench32ms and bench16_track, each chunk in the geometry of
     its own scan
     (the LPC kernels in ns a step), summed per call against the summed
     bound; then the same chunks of bench16 and bench16_track in the
     JAX package's layout (one more host scan of each chunk's byte
     range), every kernel held against its plain version and timed
     there too;
  5. drives both main paths, each with the launch counters reset just
     before and read just after (each kernel of the path must have
     launched): decode_to_device on each bench stream and on
     bench16_track (whose launches must be those of its chunks'
     classes), and the rows engine, decode(engine="torch"), on each
     bench stream and bench16_513; checks the
     PCM against the encoder's input and the native C++ decoder, with
     the stream MD5 verified, and each chunk tensor of decode_to_device
     against the geometry [Fp, Bp, C] of its scan; then the same for
     every corpus stream through both engines, bench16 in 256-frame
     chunks, and a corrupted stream that must raise InvalidChecksum;
  6. runs the rows engine's other entry points on the card:
     decode_pipelined on bench16 (several chunks), stream_decode on
     bench24, decode_range on bench16 (three ranges) and decode_tolerant
     on a corrupted corpus stream (against the same call on the CPU);
  7. times reconstruct_pack2 on each bench stream's whole-stream chunk
     from a device buffer (CUDA events; end-to-end times are the
     benchmark's, benchmark/run.py);
  8. faults: empty shapes (B == 0, n == 0, NGp == 0, Fp == 0) through
     every kernel wrapper on the card give the plain versions' empty
     results without a launch; a decode leaves the thread's current
     CUDA device as it found it, and, on a host with several cards, a
     decode on cuda:1 from a thread on cuda:0 equals the cuda:0 result;
  9. sharded: decode_to_device_sharded of each bench stream over every
     visible card (over four slots on cuda:0 when there is one) and
     over one slot of cuda:0, with the launch counters reset before and
     read after (rice16, the LPC kernel and packtail must equal those
     of each live chunk's own classes), each chunk's tensor in its own
     card geometry [F_i, Bp, C] (the chunks re-derived from the JAX
     chunk-size rule and the same scan), sharded_to_host against the
     encoder's input with the MD5 verified, the completeness count
     against the block sizes, one case of three or more rounds, and
     every kernel against its plain version on each chunk of each of
     these calls; for bench16 and bench24 on four, two and one slots
     of cuda:0, the PCM bytes a call keeps, the device memory it adds at
     its peak and reconstruct_pack2 summed over its chunks (CUDA
     graphs); reconstruct_sharded on each bench
     stream's rows plan against the single-device reconstruction
     (lpc / lpc64 counted, and held against the plain version on each
     device's slice of the plan, in shard_plan's kernel shapes);
 10. longstream: decode_longstream of bench16 and bench24 in 4 shards
     (launches counted; lpc / lpc64 against the plain version on each
     shard's plan);
 11. distributed: two worker processes that share cuda:0, over gloo
     (python3 -m zflac_tpu_torch.parallel.distributed ... pack2 cuda:0,
     then ... longstream cuda:0), on bench16: both outputs must equal
     the encoder's input, the launch counts each worker prints must be
     those of its own chunk (each scanned once, in its own geometry) or
     shard (each pack2 worker's scan_ms and its chunk's geometry are
     printed); the kernels are held against their plain versions on the
     two workers' chunks and plans;
 12. cli: python3 -m zflac_tpu_torch.cli decode, verify and bench on
     bench16 as three processes at once (the WAV's payload must equal
     the encoder's input), and verify once more through cli.main in
     this process with the launches counted;
 13. profile: one decode of bench16 in a process with
     ZFLAC_TPU_PROFILE set; the trace file must hold the region's label
     and one of the port's kernels;
 14. tools: python3 -m zflac_tpu_torch.tools.bench (its frames must be
     bench16's, its MD5 verified, its gpu_chip_msps positive) and
     tools.bench_kernels as processes, one after the other (bench's
     gpu_chip_msps[_24] within 25 % of bench_kernels' stream rows,
     the same graphs timed in another process); the stage
     profile of reconstruct_pack2 on bench16 and bench24
     (tools/profile_pack2.py, every stage from a CUDA graph); the
     playback example on bench16 as a process (its WAV's payload must
     equal the encoder's input, exit 0);
 15. fuzz: 40 byte mutations of the fuzz's streams through its four
     entries on the card (tools/fuzz_native.py: only decodes and typed
     errors; the tolerant decode and pack2's reconstruct_pack2 also run
     on the CPU, the kernels' plain versions, and must give the same
     PCM and stats or the same error class), then a synchronize and
     bench16 through decode_to_device, bit-exact, to show that the
     CUDA context survived;
 16. rice_groups: ops/rice.py's rows_from_groups of bench16 on the card
     must equal the scan's host rows;
 17. vectors: the JAX suite's independent bitstreams
     (zflac_tpu_torch/tools/vectors.py: the 20 hand-built vectors, the
     three RFC 9639 examples, the six edge-case streams): each stream
     pack2 admits has every kernel of its pack2 chunk and rows plan
     (also safe_lpc) held against its plain version, and decodes on the
     card through decode_to_device, decode(engine="torch") (also
     safe_lpc) and decode_tolerant to its expected PCM; then the
     declared-total cut and the front door with a path, a bytearray and
     a memoryview. rice16, lpc2 (on v_lpc_order32's order-32 class too),
     packtail, lpc and lpc64 must each launch in the checks and in the
     decodes.

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
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

import zflac_tpu_torch
from zflac_tpu_torch import _kernels, cli
from zflac_tpu_torch import format as fmt
from zflac_tpu_torch.bitio import BitReader
from zflac_tpu_torch.errors import InvalidChecksum
from zflac_tpu_torch.index import build_plan, native_indexer
from zflac_tpu_torch.index.native_indexer import (build_plan_native,
                                                  decode_cpu_native)
from zflac_tpu_torch.oracle import parse_metadata
from zflac_tpu_torch.parallel import make_mesh, reconstruct_sharded
from zflac_tpu_torch.parallel.distributed import range_chunks
from zflac_tpu_torch.parallel.longstream import (decode_longstream,
                                                 shard_index)
from zflac_tpu_torch.parallel.shard import (decode_to_device_sharded,
                                            local_plan, shard_plan,
                                            sharded_chunk_frames,
                                            sharded_to_host)
from zflac_tpu_torch.testing import make_corpus
from zflac_tpu_torch.ops.lpc import (KERNEL as LPC_ROWS_KERNEL,
                                     lpc_reconstruct, lpc_reconstruct_ref)
from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct_ref
from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct_ref,
                                       lpc2w_reconstruct_ref)
from zflac_tpu_torch.ops.packtail import packtail, packtail_ref
from zflac_tpu_torch.ops.rice import rows_from_groups
from zflac_tpu_torch.ops.rice16 import (rice16_unpack, rice16_unpack_ref,
                                        rice16_unpack_rows,
                                        rice16_unpack_rows_ref)
from zflac_tpu_torch.runtime import decode as rd
from zflac_tpu_torch.runtime import device as rt
from zflac_tpu_torch.runtime.pack import unpack
from zflac_tpu_torch.runtime.reconstruct import (fixed_integrate,
                                                fixed_integrate_t,
                                                lpc_lanes_inputs)
from zflac_tpu_torch.runtime.wide import join_i64
from zflac_tpu_torch.tools import fuzz_native, profile_pack2
from zflac_tpu_torch.tools.kernel_inputs import packtail_inputs, rice_groups
from zflac_tpu_torch.tools.kernel_sass import kernel_name
from zflac_tpu_torch.tools.streams import (BENCH, BENCH_BLOCK, BY_BPS,
                                           ODD_SAMPLES, TRACK_SAMPLES,
                                           bench_path, bench_pcm,
                                           bench_stream, first_chunk,
                                           three_class_stream)
from zflac_tpu_torch.tools.vectors import (EXAMPLE_2, EXAMPLE_2_SAMPLES,
                                           all_vectors, declared_total_cut,
                                           expected_output)
from zflac_tpu_torch.utils.cudatime import REPS, cuda_ms, gpu_line, graph_ms

# bench16 cut to 513 frames (tools/streams.py ODD_SAMPLES): a frame
# count one past a power of two, for the rows engine.
ODD = "bench16_513"
# bench16's signal at a 3 min 30 s track's length (TRACK_SAMPLES, 2261
# frames): decode_to_device's 8 ranges of 282-283 frames are not near a
# power of two, so its chunks show the card layout's Fp and lanes.
TRACK = "bench16_track"
# The kernels each bench stream's rows-engine path must launch.
ROWS_PATH = {"bench16": ("lpc",), "bench24": ("lpc64",),
             "bench32ms": ("lpc64",), ODD: ("lpc",)}
# Corpus streams whose card-layout chunk must show a Bp that is no
# multiple of 128 (the JAX layout's is), and one of several classes.
CARD_BP_CASES = ("blocksize 16", "blocksize 192", "blocksize 725",
                 "blocksize 1000")
MULTI_CLASS_CASE = "constant heavy"
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


# The kernels whose launch takes less device time than the host takes
# to issue it from Python, at the main path's shapes: their batches of
# back-to-back calls measure the host, so they are timed from a graph.
STREAMING = ("rice16", "rice16_flat", "packtail")


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
    fixed = fixed_launch_checks(diff, what, lpc_name, rows_t, buf, geom)
    stack = rt.sorted_stack(rows_t, buf, geom, container_bits=cb)
    tail = rt.tail_inputs(buf, geom)
    if geom.C == 2 and cb in (8, 16):
        diff.check("packtail", what,
                   packtail(stack, *tail, Fp=geom.Fp, container_bits=cb),
                   packtail_ref(stack, *tail, Fp=geom.Fp,
                                container_bits=cb))
    return dict(ck=ck, buf=buf, geom=geom, win=win, meta=meta, lpc=lpc,
                lpc_name=lpc_name, stack=stack, tail=tail, cb=cb,
                fixed=fixed)


def fixed_launch_checks(diff: Diff, what: str, lpc_name: str, rows_t, buf,
                        geom) -> int:
    """The launch that holds the chunk's fixed class in class_stack
    (rt.lpc_launches' "fixed": the fixed lanes at hist 8, and the lpc8
    class where the chunk has one) against its plain version, and its
    fixed lanes against fixed_integrate_t, the seeded cumsums the JAX
    package runs, on the card. Returns the fixed lanes checked (0 for a
    chunk without a fixed class)."""
    args = rt.lpc_launches(rows_t, buf, geom).get("fixed")
    if args is None:
        return 0
    got = rt.LPC_KERNELS[lpc_name](*args)
    diff.check(lpc_name, f"{what} fixed launch", got,
               LPC_PLAIN[lpc_name](*args))
    sl = dict(rt._class_slices(geom))["fixed"]
    seeds_t = geom.sect(buf, "seeds", geom.Ssort * 4).view(4, geom.Ssort)
    if geom.wide:
        seeds_t = join_i64(
            geom.sect(buf, "seeds_hi", geom.Ssort * 4).view(4, geom.Ssort),
            seeds_t)
    n = sl.stop - sl.start
    diff.check(lpc_name, f"{what} fixed lanes against fixed_integrate_t",
               got[:, :n], fixed_integrate_t(rows_t[:, sl], args[3][:n],
                                             seeds_t[:, sl]))
    return n


# The synthetic fixed lanes: a parallel-scan chunk's class and bench16's
# lpc8 class, at the bench block, as a lane slice 32 lanes into a wider
# array (where the fixed class sits in a chunk with a const class).
FIXED_N = (256, 2048)
FIXED_FORMS = (("lpc2", np.int32, 16), ("lpc2", np.int32, 32),
               ("lpc2w", np.int32, 32), ("lpc2w33", np.int64, 24),
               ("lpc2w33", np.int64, 33))


def fixed_signal_inputs(rng, n: int, B: int, bits: int, dtype):
    """Seeded fixed-predictor lanes of orders 0-4 in turn: random
    samples of `bits` bits [B, n], the rows as the scan leaves them
    (warm-ups at t < order, the order-th differences after) and the
    scan's finite-difference seeds [4, n], all wrapped to `dtype`."""
    samples = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (B, n),
                           dtype=np.int64)
    order = (np.arange(n) % 5).astype(np.int32)
    rows = samples.copy()
    for k in range(1, 5):
        lanes = order == k
        rows[k:, lanes] = np.diff(samples[:, lanes], n=k, axis=0)
    tri = np.array([[1, 0, 0, 0], [-1, 1, 0, 0], [1, -2, 1, 0],
                    [-1, 3, -3, 1]], dtype=np.int64)
    seeds = tri @ samples[:4]
    seeds[np.arange(4)[:, None] >= order[None, :]] = 0
    return (samples.astype(dtype), rows.astype(dtype), seeds.astype(dtype),
            order)


def fixed_signal_checks(rng, t, diff: Diff) -> list:
    """Fixed lanes through lpc2 (16-bit samples, and full-range int32
    ones whose sums wrap), lpc2w (full-range int32) and lpc2w33 (24- and
    33-bit samples in int64) with rt.fixed_cfwd's coefficients and shift
    0, at B 4096 and FIXED_N lanes: equal to the samples and to
    fixed_integrate_t on the card, bit for bit. Returns a line a case."""
    out = []
    for name, dtype, bits in FIXED_FORMS:
        for n in FIXED_N:
            samples, rows, seeds, order = fixed_signal_inputs(
                rng, n, 4096, bits, dtype)
            wide = t(np.pad(rows, ((0, 0), (32, 32))))[:, 32:32 + n]
            order_t = t(order)
            got = rt.LPC_KERNELS[name](
                wide, rt.fixed_cfwd(order_t),
                torch.zeros(n, dtype=torch.int32, device=order_t.device),
                order_t)
            what = f"fixed lanes, {bits}-bit samples, n={n}"
            diff.check(name, f"{what} against the samples", got, t(samples))
            diff.check(name, f"{what} against fixed_integrate_t", got,
                       fixed_integrate_t(t(rows), order_t, t(seeds)))
            out.append(f"{name} {bits}-bit [4096, {n}]")
    return out


def staged_tensors(staged, dev) -> tuple:
    """A staged rows-engine plan (rd.StagedPlan) on `dev` in one upload,
    as launch_plan uploads it: (its arrays by name, its padded class
    lists by name), views of the one buffer."""
    t = unpack(rt.upload(staged.buf, dev), staged.spec)
    return t, {n: t["ci_" + n] for n in staged.class_names}


def rows_fixed_checks(dev, diff: Diff, what: str, plan) -> int:
    """The rows engine's launch that holds a plan's fixed class
    (reconstruct_core: the fixed lanes, then the lpc class's where the
    plan has one, lpc_lanes_inputs) through lpc or lpc64 against its
    plain version, and its fixed lanes against fixed_integrate, the
    seeded cumsums the JAX package runs, on the card. Returns the fixed
    lanes checked (0 for a plan without a fixed class)."""
    t, ci = staged_tensors(rd.stage_plan(plan), dev)
    if "fixed" not in ci:
        return 0
    _, args = lpc_lanes_inputs(t["rows"], t["coeffs"], t["shift"],
                               t["order"], ci["fixed"], ci.get("lpc"))
    kernel = LPC_ROWS_KERNEL[args[0].dtype]
    got = lpc_reconstruct(*args)
    diff.check(kernel, f"{what} fixed launch", got,
               lpc_reconstruct_ref(*args))
    n = len(plan.classes()["fixed"])
    members = ci["fixed"][:n].long()
    seeds = torch.as_tensor(plan.fixed_seeds, device=dev)[members]
    diff.check(kernel, f"{what} fixed lanes against fixed_integrate",
               got[:, :n].t(), fixed_integrate(
                   t["rows"][members], t["order"][members], seeds))
    return n


# The rows engine's synthetic fixed lanes: lpc on 16-bit samples and on
# full-range int32 ones whose sums wrap, lpc64 on 24- and 33-bit ones.
ROWS_FIXED_FORMS = ((np.int32, 16), (np.int32, 32), (np.int64, 24),
                    (np.int64, 33))


def rows_fixed_signal_checks(rng, t, diff: Diff) -> list:
    """Seeded fixed lanes of orders 0-4 as a rows-engine plan's fixed
    class (subframe-major rows, no coefficients, shift 0) through
    lpc_lanes_inputs and lpc or lpc64 at B 4096 and FIXED_N lanes: equal
    to the samples and to fixed_integrate_t on the card, bit for bit.
    Returns a line a case."""
    out = []
    for dtype, bits in ROWS_FIXED_FORMS:
        for n in FIXED_N:
            samples, rows, seeds, order = fixed_signal_inputs(
                rng, n, 4096, bits, dtype)
            _, args = lpc_lanes_inputs(
                t(rows.T), t(np.zeros((n, 32), np.int32)),
                t(np.zeros(n, np.int32)), t(order),
                t(np.arange(n, dtype=np.int32)), None)
            kernel = LPC_ROWS_KERNEL[args[0].dtype]
            got = lpc_reconstruct(*args)
            what = f"rows fixed lanes, {bits}-bit samples, n={n}"
            diff.check(kernel, f"{what} against the samples", got,
                       t(samples))
            diff.check(kernel, f"{what} against fixed_integrate_t", got,
                       fixed_integrate_t(t(rows), t(order), t(seeds)))
            out.append(f"{kernel} {bits}-bit [4096, {n}]")
    return out


def device_kernels(fn) -> Counter:
    """The device kernels fn() runs, name -> launches, from one
    torch.profiler pass."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).split(".")[-1] == "CUDA"
        and not e.is_user_annotation())


def scan_free(seen: Counter, where: str, kernel: str) -> str:
    """Raises if `seen` (device_kernels) holds a kernel of torch.cumsum's
    outer-dim scan, or no `kernel` (no device activity recorded).
    Returns the kernels' short names with their counts."""
    if (any("scan_outer_dim" in k for k in seen)
            or not any(kernel in k for k in seen)):
        raise AssertionError(f"{where}: device kernels {dict(seen)}")
    short = Counter()
    for k, n in seen.items():
        short[re.sub(r"<.*", "", k.replace("void ", "")).split("::")[-1]] += n
    return "; ".join(f"{k} x {n}" for k, n in sorted(short.items()))


def scan_free_check(dev, chunks) -> str:
    """One torch.profiler pass over reconstruct_pack2 on each (name,
    Pack2Chunk): raises if a device kernel of torch.cumsum's outer-dim
    scan ran, or if the trace shows no lpc2 kernel (no device activity
    recorded). Returns the kernels seen, with their counts."""
    loaded = [(rt.chunk_to_torch(ck, dev),
               fmt.container_bits(ck.bits_per_sample)) for _, ck in chunks]

    def run():
        for (buf, geom), cb in loaded:
            rt.reconstruct_pack2(buf, geom, container_bits=cb)
    return scan_free(device_kernels(run), f"reconstruct_pack2 on "
                     f"{[name for name, _ in chunks]}", "lpc2_kernel")


def rows_scan_free_check(dev, plans) -> str:
    """The same for the rows engine: one torch.profiler pass over
    launch_plan (upload and reconstruct_core) on each (name, StreamPlan)
    must show an lpc kernel and no outer-dim scan."""
    staged = [rd.stage_plan(plan) for _, plan in plans]

    def run():
        for st in staged:
            rd.launch_plan(st, dev)
    return scan_free(device_kernels(run), f"launch_plan on "
                     f"{[name for name, _ in plans]}", "lpc_kernel")


def class_lpc_checks(diff: Diff, what: str, t: dict, lists: dict) -> dict:
    """lpc / lpc64 against their plain version on plan tensors `t`
    (rows, coeffs, shift, order), gathered by the padded class lists
    `lists` ("lpc" at the rows' dtype, "lpc_wide" widened to int64) as
    reconstruct_core gathers them. Returns class name -> kernel
    arguments."""
    out = {}
    for name, idx in lists.items():
        _, args = lpc_lanes_inputs(t["rows"], t["coeffs"], t["shift"],
                                   t["order"], None, idx)
        if name == "lpc_wide":
            args = (args[0].long(), *args[1:])
        diff.check(LPC_ROWS_KERNEL[args[0].dtype], f"{what} {name}",
                   lpc_reconstruct(*args), lpc_reconstruct_ref(*args))
        out[name] = args
    return out


def rows_lpc_checks(dev, diff: Diff, what: str, plan,
                    safe_lpc: bool = False) -> dict:
    """class_lpc_checks on the LPC classes of a rows-engine plan,
    staged and uploaded as _run_reconstruct does it."""
    if safe_lpc:
        plan.wide = plan.kind == 3
    t, ci = staged_tensors(rd.stage_plan(plan), dev)
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


# Member counts of an LPC class for class_pad_checks: one lane, a part
# of a warp, one past a warp, and bench16_513's lpc class (1026 members).
PAD_COUNTS = (1, 7, 33, 1026)


def class_pad_checks(rng, t, diff: Diff) -> list:
    """lpc and lpc64 against their plain versions on classes of
    PAD_COUNTS members, gathered as reconstruct_core gathers them: the
    members spread over subframe-major plan rows [S, 4096], the list
    padded with the sentinel S to a multiple of rd.CLASS_GROUP as
    pad_plan pads it. Every gathered lane slice must have the row
    stride and base of the ring's 16-byte copies. Returns the kernel
    shapes checked."""
    done = []
    for name in ("lpc", "lpc64"):
        for count in PAD_COUNTS:
            rows, cf, shift, order = ring_inputs(rng, name, count,
                                                 BENCH_BLOCK, 32)
            S = count + 5
            members = np.sort(rng.choice(S, count, replace=False))

            def spread(a):  # subframe-major, the members among S rows
                out = np.zeros((S, *a.shape[1:]), a.dtype)
                out[members] = a
                return out

            idx = np.full(-(-count // rd.CLASS_GROUP) * rd.CLASS_GROUP, S,
                          np.int32)
            idx[:count] = members
            _, args = lpc_lanes_inputs(*(t(spread(a)) for a in
                                         (rows.T, cf.T, shift, order)),
                                       None, t(idx))
            n = args[0].shape[1]
            if args[0].stride(0) % 4 or args[0].data_ptr() % 16:
                raise AssertionError(f"{name}: a class of {count} members "
                                     f"padded to {n} lanes is unaligned")
            diff.check(name, f"a class of {count} members padded to {n}",
                       lpc_reconstruct(*args), lpc_reconstruct_ref(*args))
            done.append(f"{name} {count} -> [{BENCH_BLOCK}, {n}]")
    return done


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
                odd_ins: dict, line: str) -> None:
    """lpc64 on bench32ms's rows class and bench16's safe_lpc class
    (beside bench24's, timed with the others), lpc and lpc64 on
    bench16_513's classes of 1026 members (n 1056), and the redesigned
    kernels on order-32 inputs (hist 32), checked against their plain
    versions first: kernel ms and ns a step against the bound."""
    for label, (name, args) in hist32.items():
        kern, plain = ring_fns(name)
        diff.check(name, label, kern(*args), plain(*args))
    cases = {"lpc64 bench32ms rows lpc": ("lpc64",
                                          rows_ins["bench32ms"]["lpc"]),
             "lpc64 bench16 safe_lpc rows lpc_wide": (
                 "lpc64", safe_ins["lpc_wide"]),
             f"lpc {ODD} rows lpc": ("lpc", odd_ins["lpc"]),
             f"lpc64 {ODD} safe_lpc rows lpc_wide": ("lpc64",
                                                     odd_ins["lpc64"]),
             **hist32}
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


def jax_chunks(data: bytes, cks) -> list:
    """The same chunks in the JAX package's layout ("jax"), as the port
    scanned them before the card layout: each chunk's byte range
    scanned once more on the host (Bp a multiple of 128, the chunk's
    W), and not uploaded."""
    br = BitReader(data)
    info = parse_metadata(br)
    starts = [br.pos // 8] + [ck.landed for ck in cks[:-1]]
    Bp = rt.slot_block(max(info.max_block_size, 16))
    out = []
    for a, ck in zip(starts, cks):
        j = native_indexer.pack2_range(data, a, ck.landed, info,
                                       max_frames=ck.F, force_bp=Bp,
                                       force_w=ck.W, layout="jax")
        if j is None or (j.F, j.landed) != (ck.F, ck.landed):
            raise AssertionError("the jax-layout scan of a chunk's range "
                                 "differs from the card layout's")
        out.append(j)
    return out


def layout_times(dev, diff: Diff, name: str, data: bytes, card: list,
                 line: str) -> None:
    """decode_to_device's chunks of `name` in the JAX package's layout,
    on the card-layout chunks' byte ranges (jax_chunks): every kernel
    held against its plain version, and path_times' kernel sums on
    them. `card` is kernel_checks' dicts of the card-layout chunks."""
    jax = [kernel_checks(dev, diff, f"{name} JAX-layout chunk {i}", ck)
           for i, ck in enumerate(jax_chunks(data, [d["ck"] for d in card]))]
    path_times(f"{name} (JAX layout)", jax, line)


def peak_bytes(fn) -> tuple:
    """fn()'s result and the device memory it adds at its peak on the
    current card (max_memory_allocated after reset_peak_memory_stats,
    less what was allocated before), synchronized."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


def same_shapes(name: str, dd, path: list) -> None:
    """decode_to_device's chunk tensors must have the shapes [Fp, Bp, C]
    of its scan's chunks (`path`: kernel_checks' dicts of the same
    stream's stream_chunks)."""
    got = [tuple(t.shape) for t in dd.chunks]
    want = [(d["ck"].Fp, d["ck"].Bp, d["ck"].C) for d in path]
    if got != want:
        raise AssertionError(f"{name}: decode_to_device's chunk shapes {got} "
                             f"differ from its scan's geometries {want}")


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
    verified, completeness count equal to the block sizes, each chunk's
    tensor in its own card geometry [F_i, Bp, C] on mesh[i % D], every
    round but the last full, and each kernel launched once per live
    chunk and class; then each kernel against its plain version on
    every chunk of the call, on the chunk's device. Returns (meta, the
    launch counts, the rounds, kernel_checks' dicts of the chunks, the
    call's chunk size)."""
    _kernels.launches.clear()
    r = decode_to_device_sharded(data, mesh, **kw)
    if r is None:
        raise AssertionError(f"{what}: decode_to_device_sharded declined")
    out, meta = r
    sync_mesh(mesh)
    got = dict(_kernels.launches)
    bps, C = meta["bits_per_sample"], meta["channels"]
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
    # The chunks the call reconstructed, re-derived: the JAX chunk-size
    # rule (or the call's own chunk_frames) and the same scan, each
    # chunk in its own card geometry.
    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    cf = kw.get("chunk_frames") or sharded_chunk_frames(data, pos, info,
                                                        len(mesh))
    cks = rt.stream_chunks(data, info, pos, chunk_frames=cf)
    D = len(mesh)
    live = len(meta["num_frames"])
    if len(cks) != live or meta["rounds"] != -(-live // D):
        raise AssertionError(f"{what}: {live} chunks in {meta['rounds']} "
                             f"rounds, the scan gives {len(cks)}")
    shapes = [(tuple(t.shape), t.device) for rnd in out for t in rnd]
    expect_shapes = [((ck.F, ck.Bp, ck.C), mesh[i % D])
                     for i, ck in enumerate(cks)]
    if shapes != expect_shapes or [len(rnd) for rnd in out] != [
            min(D, live - i) for i in range(0, live, D)]:
        raise AssertionError(f"{what}: tensors {shapes}, the chunks' own "
                             f"geometries {expect_shapes}")
    expect = path_launches([rt.Pack2Geom.of(ck) for ck in cks],
                           fmt.container_bits(bps))
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect} "
                             f"({live} live chunks: {geoms_line(cks)})")
    checked = [kernel_checks(mesh[i % D], diff, f"{what} sharded chunk {i}",
                             ck) for i, ck in enumerate(cks)]
    return meta, got, out, checked, cf


def sharded_geometry(dev, name: str, data: bytes, mesh, where: str,
                     line: str) -> None:
    """One decode_to_device_sharded call of `name` on the mesh, its
    chunks in their own card geometry: the PCM bytes it keeps, the
    device memory it adds at its peak, and reconstruct_pack2 summed over
    the call's chunks (CUDA graphs timed with CUDA events). One card
    only: the memory counters are the current card's."""
    (out, meta), peak = peak_bytes(
        lambda: decode_to_device_sharded(data, mesh))
    kept = sum(t.numel() * t.element_size() for rnd in out for t in rnd)
    del out
    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    cf = sharded_chunk_frames(data, pos, info, len(mesh))
    cks = rt.stream_chunks(data, info, pos, chunk_frames=cf)
    ins = [(*rt.chunk_to_torch(ck, dev),
            fmt.container_bits(ck.bits_per_sample)) for ck in cks]
    t = [sum(graph_ms(lambda b=b, g=g, cb=cb: rt.reconstruct_pack2(
        b, g, container_bits=cb)) for b, g, cb in ins) for _ in range(2)]
    say("sharded", f"{name}: decode_to_device_sharded over {where}, "
        f"chunk size {cf}, {len(cks)} chunks in {meta['rounds']} "
        f"rounds: scan buffers {sum(c.device_buf.nbytes for c in cks)} B, "
        f"PCM {kept} B in the chunks' own geometry (frames "
        f"{[ck.F for ck in cks]}, Bp {cks[0].Bp}); device memory added at "
        f"the peak {peak} B ({peak / 2**20:.3f} MiB); reconstruct_pack2 "
        f"summed over the call's chunks (median of {REPS} graph replays "
        f"each, CUDA events, two passes) {t[0]:.4f} / {t[1]:.4f} ms; on "
        f"{line}")


def path_launches(geoms, cb: int) -> dict:
    """The launches reconstruct_pack2 makes on chunks of these
    geometries: rice16 once a chunk, the chunk's LPC kernel once per LPC
    class and once more for a fixed class without an lpc8 class to share
    a launch with, packtail once a stereo chunk in an 8/16-bit
    container."""
    expect = Counter()
    for g in geoms:
        expect["rice16"] += 1
        names = [name for name, _ in g.classes]
        n_lpc = sum(name.startswith("lpc") for name in names) + (
            "fixed" in names and "lpc8" not in names)
        if n_lpc:
            expect[rt.lpc_kernel(g, cb)] += n_lpc
        if g.C == 2 and cb in (8, 16):
            expect["packtail"] += 1
    return dict(expect)


def geom_line(ck) -> str:
    """A pack2 chunk's frames and geometry: F, Fp, Bp, its lanes
    (Ssort), W, NGp, wide, and each class's members n and lanes np."""
    classes = ", ".join(f"{c} n {n} np {np_}" for c, n, np_ in ck.classes)
    return (f"F {ck.F}, Fp {ck.Fp}, Bp {ck.Bp}, lanes (Ssort) {ck.Ssort}, "
            f"W {ck.W}, NGp {ck.NGp}, wide {ck.wide}, classes [{classes}]")


def geoms_line(cks) -> str:
    """The distinct geometries of a list of chunks, each with the
    number of chunks that have it."""
    seen = Counter(geom_line(ck) for ck in cks)
    return "; ".join(f"{n} x ({text})" for text, n in seen.items())


def sharded_phase(diff: Diff, benches: dict, mesh, line: str,
                  launches: dict) -> None:
    D = len(mesh)
    where = (f"{D} cards" if len(set(mesh)) > 1
             else f"{D} slots on {mesh[0]}")
    one = make_mesh(["cuda:0"])
    for name, (data, want) in benches.items():
        for m, w in ((mesh, where), (one, "1 slot on cuda:0")):
            meta, got, out, checked, cf = sharded_decode_check(
                diff, name, data, want, m)
            say("sharded", f"{name}: decode_to_device_sharded over {w} -> "
                f"sharded_to_host (MD5 verified) == encoder input; "
                f"{len(meta['num_frames'])} chunks of {meta['num_frames']} "
                f"frames (chunk size {cf}) in {meta['rounds']} rounds "
                f"({[len(rnd) for rnd in out]} tensors), each tensor in "
                f"its chunk's own card geometry; completeness count "
                f"{int(meta['psum_samples'])} == channels x block sizes; "
                f"kernel launches {got} == those of the chunks' own "
                f"classes; every kernel == its plain version on each chunk "
                f"({geoms_line([d['ck'] for d in checked])})")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
    meta, got, out, checked, _ = sharded_decode_check(
        diff, f"bench16, chunk_frames={ROUND_FRAMES}", *benches["bench16"],
        mesh, chunk_frames=ROUND_FRAMES)
    if meta["rounds"] < 3:
        raise AssertionError(f"chunk_frames={ROUND_FRAMES} gave "
                             f"{meta['rounds']} rounds")
    say("sharded", f"bench16 in {len(meta['num_frames'])} chunks of at most "
        f"{ROUND_FRAMES} frames, {meta['rounds']} rounds over {where} "
        f"({[len(rnd) for rnd in out]} tensors): bit-exact, launches {got}; "
        f"every kernel == its plain version on each chunk "
        f"({geoms_line([d['ck'] for d in checked])})")
    # PCM bytes, peak memory and device time in the chunks' own geometry
    # on four, two and one slots of cuda:0.
    dev = torch.device("cuda", 0)
    for name in ("bench16", "bench24"):
        for k in (4, 2, 1):
            sharded_geometry(dev, name, benches[name][0],
                             make_mesh(["cuda:0"] * k),
                             f"{k} slot{'s' if k > 1 else ''} on cuda:0", line)

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
        # lpc / lpc64 on each device's slice as reconstruct_sharded
        # uploads it: a share of the lanes, class lists sentinel-padded
        # to a multiple of 32, rows [S_loc, B8] (shard_plan's shapes).
        arrays, smeta = shard_plan(plan, D)
        cb = fmt.container_bits(plan.info.bits_per_sample)
        shapes = set()
        for d, device in enumerate(mesh):
            t, ci = staged_tensors(local_plan(arrays, smeta, d, cb), device)
            for args in class_lpc_checks(
                    diff, f"{name} reconstruct_sharded device {d}", t,
                    {n: ci[n] for n in ("lpc", "lpc_wide")
                     if n in ci}).values():
                shapes.add(f"{list(args[0].shape)} {args[0].dtype}")
        say("sharded", f"{name}: reconstruct_sharded of the rows plan over "
            f"{where} == _run_reconstruct on one device, PCM "
            f"{list(pcm.shape)}, total {total}; kernel launches {got}; "
            f"{kernel} == its plain version on each device's slice, rows "
            f"{sorted(shapes)}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v


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


def longstream_phase(diff: Diff, benches: dict, mesh,
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
        say("longstream", f"{name}: decode_longstream in 4 shards over "
            f"{len(mesh)} mesh slots (MD5 verified) == encoder input; "
            f"{r.stats}; kernel launches {got}; {ROWS_PATH[name][0]} == its "
            f"plain version on each shard's plan, rows {shapes}")
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
    prints its stats and launch counts, which must be those of its one
    chunk, in that chunk's own geometry (or of its one shard). Before
    that, each kernel is held against its plain version here on the
    chunks and shard plans the workers make."""
    dev = torch.device(CARD)
    # Outside any process group, two local ranges are the two workers'
    # ranges, each scanned as its worker scans it.
    br = BitReader(data)
    info = parse_metadata(br)
    _, cks = range_chunks(data, info, br.pos // 8, 2)
    if cks is None or len(cks) != 2:
        raise AssertionError("distributed: the two ranges' pack2 scan "
                             "declined")
    for i, ck in enumerate(cks):
        kernel_checks(dev, diff, f"bench16 worker {i} pack2 chunk", ck)
    geoms = [rt.Pack2Geom.of(ck) for ck in cks]
    cb = fmt.container_bits(info.bits_per_sample)
    expect = {"pack2": [path_launches([g], cb) for g in geoms],
              "longstream": [{"lpc": 1}] * 2}
    shapes = shard_lpc_checks(diff, "bench16 worker", data, 2, [dev])
    say("distributed", "every kernel == its plain version on each "
        "worker's pack2 chunk in its own geometry (" + "; ".join(
            f"worker {r}: {geom_line(ck)}" for r, ck in enumerate(cks))
        + f") and lpc on their long-stream plans, rows {shapes}")

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
        # Each worker's last line: "process r/2: {stats}; kernel
        # launches {counts}".
        lasts = [log.strip().splitlines()[-1] for log in logs]
        stats = [ast.literal_eval(s_.split(": ", 1)[1].split(
                     "; kernel launches ")[0]) for s_ in lasts]
        counts = [ast.literal_eval(s_.split("kernel launches ")[1])
                  for s_ in lasts]
        if not all(st["engine"] == f"{engine}-distributed" and
                   st["processes"] == 2 for st in stats):
            raise AssertionError(f"distributed {engine}: {lasts}")
        if counts != expect[engine]:
            raise AssertionError(f"distributed {engine}: the workers "
                                 f"launched {counts}, expected "
                                 f"{expect[engine]}")
        each = "; ".join(
            f"process {r}: launches {c}" + (
                f", scan_ms {st['scan_ms']:.3f} (host clock), its chunk "
                f"Fp {geoms[r].Fp}, Ssort {geoms[r].Ssort}, classes "
                f"{geoms[r].classes}"
                if engine == "pack2" else "")
            for r, (st, c) in enumerate(zip(stats, counts)))
        say("distributed", f"bench16, {engine}: 2 processes on {CARD} over "
            f"gloo, both outputs == encoder input; {each}; stats "
            f"{stats[0]}; {wall:.1f} s from start to exit of both "
            f"processes (host clock, Python and CUDA start-up included); "
            f"on {line}")


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


# ---------------------------------------------------------------------
# Phases 14-16: the measuring and checking tools, the fuzz on the card,
# and the Rice group-table math.
# ---------------------------------------------------------------------

# Fuzz iterations on the card, and the A-B-A reps of the bench process.
FUZZ_ITERS = 40
TOOL_REPS = "5"


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def tools_phase(want16: np.ndarray, tmp: str, line: str) -> None:
    """The bench and bench_kernels tools as processes on the card, one
    after the other; the stage profile of bench16 and bench24 here; the
    playback example as a process on bench16 at its default period."""
    py = [sys.executable, "-m"]
    (out,) = run_procs("tools bench", [[*py, "zflac_tpu_torch.tools.bench",
                                        "--reps", TOOL_REPS]])
    b = last_json(out)
    frames = BENCH["bench16"][0] // BENCH_BLOCK
    if b["frames"] != frames or not b["md5_verified"] or \
            not b["gpu_chip_msps"] > 0 or not b["gpu_chip_msps_24"] > 0 or \
            b["engine"] != "torch":
        raise AssertionError(f"tools bench: {b}")
    say("tools", f"python3 -m zflac_tpu_torch.tools.bench --reps "
        f"{TOOL_REPS}: {json.dumps(b)}; on {line}")
    (out,) = run_procs("tools bench_kernels", [[
        *py, "zflac_tpu_torch.tools.bench_kernels"]])
    k = last_json(out)
    if not all(k[r]["pack2_msps"] > 0 for r in ("stream16", "stream24")) \
            or not all(k["kernels"][f"{n}_ms"] > 0
                       for n in ("rice16", "lpc2", "lpc2w")):
        raise AssertionError(f"tools bench_kernels: {k}")
    # bench's gpu_chip_msps[_24] are bench_kernels' stream rows, timed
    # in another process: the two must agree.
    for key, row in (("gpu_chip_msps", "stream16"),
                     ("gpu_chip_msps_24", "stream24")):
        ratio = b[key] / k[row]["pack2_msps"]
        if not 0.8 <= ratio <= 1.25:
            raise AssertionError(f"tools: bench {key} {b[key]} against "
                                 f"bench_kernels {row} "
                                 f"{k[row]['pack2_msps']}")
    say("tools", f"python3 -m zflac_tpu_torch.tools.bench_kernels: "
        f"{json.dumps(k)}; on {line}")
    for bps in (16, 24):
        p = profile_pack2.profile(bps, BENCH[BY_BPS[bps]][0], CARD)
        st = p["stages_ms"]
        if list(st) != list(profile_pack2.STAGES):
            raise AssertionError(f"profile_pack2 --bps {bps}: {p}")
        say("tools", f"profile_pack2 --bps {bps} ({p['tail']} tail), ms "
            f"cumulative / delta from CUDA graphs: " + ", ".join(
                f"{n} {v['cumulative']:.4f} / {v['delta']:+.4f}"
                for n, v in st.items())
            + f"; full {p['msps_full']:.1f} Msamples/s; on {line}")
    wav = os.path.join(tmp, "play.wav")
    (out,) = run_procs("playback", [[
        *py, "zflac_tpu_torch.examples.playback", bench_path("bench16"),
        "--out", wav, "--device", CARD]])
    with open(wav, "rb") as f:
        riff = f.read()
    if riff[44:] != want16.tobytes():
        raise AssertionError("playback: the WAV's payload differs from the "
                             "encoder input")
    say("tools", f"playback of bench16 on {CARD}: {out.strip()}; WAV "
        f"payload == encoder input, exit 0")


def fuzz_phase(benches: dict) -> None:
    """The fuzz's four entries on the card in this process, then the
    CUDA context still works: a synchronize raises nothing and bench16
    still decodes bit-exact."""
    a = time.perf_counter()
    out = fuzz_native.fuzz(FUZZ_ITERS, 0, CARD, log=lambda m: None,
                           check_device="cpu")
    wall = time.perf_counter() - a
    if out["checked"] != FUZZ_ITERS * len(fuzz_native.DEVICE_ENTRIES):
        raise AssertionError(f"fuzz: {out}")
    torch.cuda.synchronize()
    decode_check("bench16 after the fuzz", *benches["bench16"])
    say("fuzz", f"{FUZZ_ITERS} mutations x {len(fuzz_native.ENTRIES)} "
        f"entries on {CARD} in {wall:.1f} s: {out} (only decodes and "
        f"typed errors; the {', '.join(fuzz_native.DEVICE_ENTRIES)} "
        "entries' PCM and stats, or error class, equal to their plain "
        "versions' on the CPU); then synchronize clean and bench16 "
        "bit-exact through decode_to_device")


def rice_groups_phase(data: bytes) -> None:
    """ops/rice.py's group-table math on the card against the scan's
    host rows of bench16."""
    plan = build_plan_native(data, emit_groups=True)
    a = time.perf_counter()
    rows = rows_from_groups(data, plan, device=CARD)
    wall = time.perf_counter() - a
    if not np.array_equal(rows, plan.rows.astype(np.int32)):
        raise AssertionError("rice_groups: rows_from_groups on the card "
                             "differs from the scan's rows")
    say("rice_groups", f"rows_from_groups of bench16 on {CARD}: "
        f"{rows.shape} rows == the scan's host rows ({wall:.2f} s, host "
        f"clock, upload and host patching included)")


# ---------------------------------------------------------------------
# Phase 17: the JAX suite's independent bitstreams on the card.
# ---------------------------------------------------------------------

# The kernels the vectors phase must launch, in its checks and in its
# decodes; lpc2 also on v_lpc_order32's order-32 class.
VECTOR_KERNELS = ("rice16", "lpc2", "packtail", "lpc", "lpc64")


def same_pcm(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what}: {got.dtype} {got.shape} differs from "
                             f"the expected {want.dtype} {want.shape}")


def vector_decodes(v, dev) -> None:
    """Stream `v` through decode_to_device (to_host with the MD5
    verified, and the device assembly), decode(engine="torch") (also
    with safe_lpc) and decode_tolerant on `dev`, each equal to the
    vector's expected PCM."""
    dd = zflac_tpu_torch.decode_to_device(v.data, device=dev)
    if dd is None:
        raise AssertionError(f"{v.name}: decode_to_device declined")
    same_pcm(f"{v.name} decode_to_device", dd.to_host().interleaved,
             v.expected)
    same_pcm(f"{v.name} interleaved_device",
             dd.interleaved_device().cpu().numpy().reshape(-1), v.expected)
    for kw in ({}, {"safe_lpc": True}):
        r = zflac_tpu_torch.decode(v.data, engine="torch", device=dev,
                                   **v.kwargs, **kw)
        same_pcm(f"{v.name} decode(engine=torch, {kw})", r.interleaved,
                 v.expected)
    r = zflac_tpu_torch.decode_tolerant(v.data, device=dev)
    if r.stats["resyncs"] or not r.stats["md5_ok"]:
        raise AssertionError(f"{v.name} decode_tolerant: {r.stats}")
    same_pcm(f"{v.name} decode_tolerant", r.interleaved, v.expected)


def vectors_phase(dev, diff: Diff, tmp: str, launches: dict) -> None:
    """Each stream of tools/vectors.py that pack2 admits (all but the
    empty one): every kernel of its whole-stream pack2 chunk
    (kernel_checks) and of its rows-engine plan, also with safe_lpc
    (rows_lpc_checks), against its plain version; then vector_decodes
    on the card. Then the declared-total cut and the front door with a
    path, a bytearray and a memoryview. Prints each kernel's launches
    in the checks and in the decodes, with the streams that reached
    it, and raises if one of VECTOR_KERNELS did not launch in either."""
    checks, decodes = Counter(), Counter()
    reached = {}
    order32 = None
    streams = all_vectors()
    for v in streams:
        if v.name == "empty_stream":
            if zflac_tpu_torch.decode_to_device(v.data, device=dev) \
                    is not None:
                raise AssertionError("decode_to_device took the empty "
                                     "stream")
            continue
        _kernels.launches.clear()
        d = kernel_checks(dev, diff, v.name, first_chunk(v.data))
        for safe in (False, True):
            rows_lpc_checks(dev, diff, f"{v.name} rows plan"
                            f"{' safe_lpc' if safe else ''}",
                            build_plan(v.data), safe_lpc=safe)
        torch.cuda.synchronize()
        got = dict(_kernels.launches)
        if v.name == "v_lpc_order32":
            order32 = (d["lpc_name"], sorted(d["lpc"]), got.get("lpc2", 0))
        checks.update(got)
        _kernels.launches.clear()
        vector_decodes(v, dev)
        torch.cuda.synchronize()
        got_d = dict(_kernels.launches)
        decodes.update(got_d)
        for k in {*got, *got_d}:
            reached.setdefault(k, []).append(v.name)
    if order32 is None or order32[0] != "lpc2" or "lpc32" not in order32[1] \
            or not order32[2]:
        raise AssertionError(f"v_lpc_order32's chunk: LPC kernel, classes "
                             f"and lpc2 launches {order32}")
    say("vectors", f"v_lpc_order32's whole-stream chunk: classes "
        f"{order32[1]} through {order32[0]}, {order32[2]} launch(es), "
        "== its plain version")

    cut, declared = declared_total_cut()
    _kernels.launches.clear()
    dd = zflac_tpu_torch.decode_to_device(cut.data, device=dev)
    if dd is None:
        raise AssertionError("declared-total cut: decode_to_device declined")
    host = dd.to_host(verify_md5=False)
    r = zflac_tpu_torch.decode(cut.data, engine="torch", device=dev,
                               **cut.kwargs)
    for what, got in (("decode_to_device", host), ("decode", r)):
        if got.num_samples != declared:
            raise AssertionError(f"declared-total cut, {what}: "
                                 f"{got.num_samples} samples")
        same_pcm(f"declared-total cut, {what}", got.interleaved,
                 cut.expected)
    try:
        zflac_tpu_torch.decode(cut.data, engine="torch", device=dev)
    except InvalidChecksum:
        pass
    else:
        raise AssertionError("declared-total cut: the default decode "
                             "passed its MD5")
    torch.cuda.synchronize()
    decodes.update(_kernels.launches)
    say("vectors", f"declared-total cut: {declared} samples through "
        "decode_to_device and decode(engine=\"torch\") with verify_md5="
        "False; the default decode raises InvalidChecksum")

    path = os.path.join(tmp, "example2.flac")
    with open(path, "wb") as f:
        f.write(EXAMPLE_2)
    _kernels.launches.clear()
    for kind, arg in (("path", path), ("bytearray", bytearray(EXAMPLE_2)),
                      ("memoryview", memoryview(bytearray(EXAMPLE_2)))):
        dd = zflac_tpu_torch.decode_to_device(arg, device=dev)
        same_pcm(f"front door, {kind}: decode_to_device",
                 dd.to_host().interleaved, EXAMPLE_2_SAMPLES)
        same_pcm(f"front door, {kind}: decode", zflac_tpu_torch.decode(
            arg, device=dev).interleaved, EXAMPLE_2_SAMPLES)
    torch.cuda.synchronize()
    decodes.update(_kernels.launches)
    say("vectors", "front door on the card: a path, a bytearray and a "
        "memoryview of RFC 9639 Example 2 through decode_to_device and "
        "decode: the example's samples")

    for k in KERNELS:
        say("vectors", f"{k}: {checks.get(k, 0)} launches against the plain "
            f"version, {decodes.get(k, 0)} in the decodes; streams: "
            f"{', '.join(reached.get(k, [])) or 'none'}")
    missing = [k for k in VECTOR_KERNELS
               if not checks.get(k) or not decodes.get(k)]
    if missing:
        raise AssertionError(f"vectors: not launched in the checks or the "
                             f"decodes: {missing}")
    say("vectors", f"{len(streams) - 1} of {len(streams)} streams (all but "
        "the empty one, which pack2 declines) bit-exact on the card: every "
        "kernel == its plain version on each chunk and rows plan, and "
        "decode_to_device, decode(engine=\"torch\") (also safe_lpc) and "
        "decode_tolerant == the expected PCM")
    for k, n in decodes.items():
        launches[k] = launches.get(k, 0) + n


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args()
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
            max_workers=len(BENCH) + 2,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = {name: pool.submit(bench_stream, name) for name in BENCH}
        pending_odd = pool.submit(bench_stream, "bench16", ODD_SAMPLES)
        pending_track = pool.submit(bench_stream, "bench16", TRACK_SAMPLES)
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
        corpus = {name: (data, expected_output(pcm, bps))
                  for name, (data, pcm, _sr, bps) in make_corpus().items()}
        benches = {name: (fut.result(),
                          expected_output(bench_pcm(name), BENCH[name][1]))
                   for name, fut in pending.items()}
        odd = (pending_odd.result(),
               expected_output(bench_pcm("bench16", ODD_SAMPLES), 16))
        track = (pending_track.result(),
                 expected_output(bench_pcm("bench16", TRACK_SAMPLES), 16))
    say("streams", ", ".join(
        f"{name} {len(data)} B ({BENCH[name][0]} x 2 samples, "
        f"{BENCH[name][1]}-bit)" for name, (data, _) in benches.items())
        + f", {ODD} {len(odd[0])} B ({ODD_SAMPLES} x 2 samples, 16-bit, "
        f"{ODD_SAMPLES // BENCH_BLOCK} frames), {TRACK} {len(track[0])} B "
        f"({TRACK_SAMPLES} x 2 samples, 16-bit, "
        f"{-(-TRACK_SAMPLES // BENCH_BLOCK)} frames) and {len(corpus)} corpus "
        f"streams, {time.perf_counter() - t_streams:.1f} s")

    # ---- kernels against their plain versions, on the card ----
    diff = Diff()
    ins, path_ins = {}, {}
    for name, (data, _) in benches.items():
        ins[name] = kernel_checks(dev, diff, f"{name} chunk",
                                  first_chunk(data))
        # The chunks decode_to_device itself reconstructs: one per
        # anchor-split range of the parallel scan, each in the geometry
        # of its own scan.
        br = BitReader(data)
        cks = rt.stream_chunks(data, parse_metadata(br), br.pos // 8)
        path_ins[name] = [kernel_checks(dev, diff,
                                        f"{name} path chunk {i}", ck)
                          for i, ck in enumerate(cks)]
    br = BitReader(track[0])
    path_ins[TRACK] = [
        kernel_checks(dev, diff, f"{TRACK} path chunk {i}", ck)
        for i, ck in enumerate(rt.stream_chunks(
            track[0], parse_metadata(br), br.pos // 8))]
    # Every corpus stream as one card-layout chunk; among them chunks
    # whose Bp is no multiple of 128 and chunks of several classes,
    # whose class blocks start at lanes 32 and 64.
    odd_bp, multi = [], []
    fixed_seen = Counter()
    for name, (data, _) in corpus.items():
        d = kernel_checks(dev, diff, name, first_chunk(data))
        ck = d["ck"]
        fixed_seen["corpus chunks"] += d["fixed"]
        if ck.Bp % 128:
            odd_bp.append(f"{name} Bp {ck.Bp}")
        if len(ck.classes) > 1:
            multi.append(f"{name} {geom_line(ck)}")
    for name in CARD_BP_CASES:
        if not any(c.startswith(f"{name} Bp ") for c in odd_bp):
            raise AssertionError(f"{name}: its card-layout Bp is a "
                                 "multiple of 128")
    if not any(c.startswith(f"{MULTI_CLASS_CASE} ") for c in multi):
        raise AssertionError(f"{MULTI_CLASS_CASE}: one class")
    # Three classes: the LPC class's lane slice starts at lane 64.
    three = first_chunk(three_class_stream())
    if [(c, np_) for c, _, np_ in three.classes] != [
            ("const", 32), ("fixed", 32), ("lpc8", 32)]:
        raise AssertionError(f"three_class_stream: {geom_line(three)}")
    # The fixed class through the LPC kernels: seeded lanes at the bench
    # block, the fixed lanes of every chunk checked above, and no
    # torch.cumsum scan on the card where a chunk has fixed lanes (the
    # three-class chunk's fixed and lpc8 classes share a launch).
    fixed_lines = fixed_signal_checks(
        np.random.default_rng(18), lambda a: torch.as_tensor(a, device=dev),
        diff)
    for name in BENCH:
        fixed_seen[name] = sum(d["fixed"]
                               for d in (ins[name], *path_ins[name]))
    fixed_seen[TRACK] = sum(d["fixed"] for d in path_ins[TRACK])
    fixed_seen["three_class_stream"] = kernel_checks(
        dev, diff, "three_class_stream", three)["fixed"]
    if not fixed_seen["corpus chunks"] or not fixed_seen["three_class_stream"]:
        raise AssertionError(f"no fixed lanes checked: {dict(fixed_seen)}")
    scan_free = scan_free_check(dev, [
        ("bench16 chunk", ins["bench16"]["ck"]),
        ("three_class_stream", three),
        ("fixed order 2", first_chunk(corpus["fixed order 2"][0]))])
    # The rows engine's fixed class: seeded lanes at the bench block,
    # the fixed launch of every plan checked below, and no torch.cumsum
    # scan on the card (three_class_stream's fixed and lpc classes
    # share a launch, "fixed order 2" has no lpc class).
    rows_fixed_lines = rows_fixed_signal_checks(
        np.random.default_rng(21), lambda a: torch.as_tensor(a, device=dev),
        diff)
    rows_fixed_seen = Counter()
    for name, (data, _) in (*benches.items(), (ODD, odd), *corpus.items()):
        rows_fixed_seen[name if name in BENCH or name == ODD
                        else "corpus plans"] += rows_fixed_checks(
            dev, diff, f"{name} rows plan", build_plan(data))
    for name, plan in (("three_class_stream",
                        build_plan(three_class_stream())),
                       ("bench16 safe_lpc", build_plan(
                           benches["bench16"][0]))):
        if name.endswith("safe_lpc"):
            plan.wide = plan.kind == 3
        rows_fixed_seen[name] = rows_fixed_checks(
            dev, diff, f"{name} rows plan", plan)
    if (not rows_fixed_seen["corpus plans"]
            or not rows_fixed_seen["three_class_stream"]):
        raise AssertionError(f"no rows fixed lanes checked: "
                             f"{dict(rows_fixed_seen)}")
    rows_scan_free = rows_scan_free_check(dev, [
        (name, build_plan(data)) for name, data in (
            ("bench16", benches["bench16"][0]),
            ("bench24", benches["bench24"][0]),
            ("three_class_stream", three_class_stream()),
            ("fixed order 2", corpus["fixed order 2"][0]))])
    rows_ins = {name: rows_lpc_checks(dev, diff, f"{name} rows plan",
                                      build_plan(data))
                for name, (data, _) in benches.items()}
    safe_ins = rows_lpc_checks(dev, diff, "bench16 safe_lpc rows plan",
                               build_plan(benches["bench16"][0]),
                               safe_lpc=True)
    # bench16_513: classes whose member counts are not powers of two.
    odd_ins = {"lpc": rows_lpc_checks(dev, diff, f"{ODD} rows plan",
                                      build_plan(odd[0]))["lpc"],
               "lpc64": rows_lpc_checks(dev, diff,
                                        f"{ODD} safe_lpc rows plan",
                                        build_plan(odd[0]),
                                        safe_lpc=True)["lpc_wide"]}
    for name, (data, _) in corpus.items():
        rows_lpc_checks(dev, diff, f"{name} rows plan", build_plan(data))
    # The streaming kernels' synthetic inputs at the bench chunks'
    # shapes: each stream's whole-stream chunk and path chunks.
    firsts = [(d["geom"], d["cb"]) for name in BENCH
              for d in (ins[name], *path_ins[name])] + [
                  (d["geom"], d["cb"]) for d in path_ins[TRACK]]
    streamed = synthetic_checks(
        dev, diff, sorted({(g.W, g.Ssort, g.NGp // g.Ssort)
                           for g, _ in firsts}),
        sorted({(g.Fp, g.Bp) for g, cb in firsts
                if g.C == 2 and cb in (8, 16)}))
    padded = class_pad_checks(np.random.default_rng(513),
                              lambda a: torch.as_tensor(a, device=dev), diff)
    torch.cuda.synchronize()
    for name, d in ins.items():
        g = d["geom"]
        say("kernels", f"{name} whole-stream chunk: Fp {g.Fp}, Bp {g.Bp}, "
            f"Ssort {g.Ssort}, W {g.W}, NGp {g.NGp}, wide {g.wide}, "
            f"classes {g.classes}, LPC kernel {d['lpc_name']}; "
            f"decode_to_device reconstructs {len(path_ins[name])} "
            f"parallel-scan chunks: "
            f"{geoms_line([p['ck'] for p in path_ins[name]])}")
    for name, cls in rows_ins.items():
        say("kernels", f"{name} rows-engine plan: LPC classes " + ", ".join(
            f"{c} rows {list(a[0].shape)} {a[0].dtype}"
            for c, a in cls.items()))
    say("kernels", f"{ODD} rows-engine plan: " + ", ".join(
        f"{k} rows {list(a[0].shape)} {a[0].dtype}"
        for k, a in odd_ins.items()) + "; lpc and lpc64 bit-exact on "
        f"seeded classes, member count -> kernel rows: {'; '.join(padded)}")
    say("kernels", f"{TRACK}: decode_to_device reconstructs "
        f"{len(path_ins[TRACK])} parallel-scan chunks: "
        f"{geoms_line([p['ck'] for p in path_ins[TRACK]])}")
    say("kernels", f"corpus chunks in the card layout, every kernel "
        f"bit-exact: {len(odd_bp)} with Bp no multiple of 128 "
        f"({'; '.join(odd_bp)}); {len(multi)} of several classes "
        f"({'; '.join(multi)}); three_class_stream: {geom_line(three)}")
    say("kernels", f"fixed lanes through the LPC kernels (fixed_cfwd, "
        f"shift 0) == the samples and fixed_integrate_t: "
        f"{'; '.join(fixed_lines)}; the chunks' fixed lanes (launch == "
        f"plain, lanes == fixed_integrate_t), lanes checked: the bench "
        f"streams' whole-stream and path chunks, the corpus chunks and "
        f"three_class_stream (fixed and lpc8 in one launch): "
        f"{dict(fixed_seen)}")
    say("kernels", f"reconstruct_pack2 on bench16's chunk, "
        f"three_class_stream and 'fixed order 2' under torch.profiler: no "
        f"outer-dim scan; device kernels {scan_free}")
    say("kernels", f"rows engine: fixed lanes through lpc / lpc64 "
        f"(lpc_lanes_inputs, shift 0) == the samples and "
        f"fixed_integrate_t: {'; '.join(rows_fixed_lines)}; the plans' "
        f"fixed launches (launch == plain, lanes == fixed_integrate), "
        f"lanes checked: {dict(rows_fixed_seen)}; launch_plan on bench16, "
        f"bench24, three_class_stream and 'fixed order 2' under "
        f"torch.profiler: no outer-dim scan; device kernels "
        f"{rows_scan_free}")
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
    extra_times(diff, hist32_inputs(dev), rows_ins, safe_ins, odd_ins, line)
    for name in (*BENCH, TRACK):
        path_times(name, path_ins[name], line)
    for name, data in (("bench16", benches["bench16"][0]),
                       (TRACK, track[0])):
        layout_times(dev, diff, name, data, path_ins[name], line)

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
        same_shapes(name, dd, path_ins[name])
    _kernels.launches.clear()
    dd = decode_check(TRACK, *track)
    torch.cuda.synchronize()
    got = dict(_kernels.launches)
    expect = path_launches([d["geom"] for d in path_ins[TRACK]], 16)
    say("slice", f"{TRACK}: decode_to_device -> to_host (MD5 verified) == "
        f"encoder input == native decoder; chunks {len(dd.chunks)}, frames "
        f"{dd.stats['frames']}; kernel launches {got}, those of its "
        f"chunks' classes {expect}")
    if got != expect:
        raise AssertionError(f"{TRACK}: launches {got}, expected {expect}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    same_shapes(TRACK, dd, path_ins[TRACK])

    # ---- the rows engine's main path, counted per bench stream and on
    # bench16_513 ----
    for name, (data, want) in (*benches.items(), (ODD, odd)):
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
    data3 = three_class_stream()
    decode_check("three_class_stream", data3, native_pcm(data3))
    say("slice", f"{len(corpus)} corpus streams and three_class_stream "
        "bit-exact through decode_to_device; the corpus streams "
        "through both "
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

    # ---- the faults repaired; the multi-device, multi-process and
    # command-line paths ----
    faults_phase(dev, benches)
    mesh = make_mesh() if torch.cuda.device_count() > 1 \
        else make_mesh(["cuda:0"] * 4)
    sharded_phase(diff, benches, mesh, line, launches)
    longstream_phase(diff, benches, mesh, launches)
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        distributed_phase(diff, *benches["bench16"], tmp, line)
        cli_and_profile_phase(benches["bench16"][1], tmp, line)
        t_new = seconds(lambda: tools_phase(benches["bench16"][1], tmp,
                                            line))
    t_new += seconds(lambda: fuzz_phase(benches))
    t_new += seconds(lambda: rice_groups_phase(benches["bench16"][0]))
    say("device", f"phases tools, fuzz and rice_groups: {t_new:.0f} s")
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        t_vec = seconds(lambda: vectors_phase(dev, diff, tmp, launches))
    say("device", f"phase vectors: {t_vec:.1f} s")
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
