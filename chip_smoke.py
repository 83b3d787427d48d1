#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zflac_tpu_torch) on one NVIDIA
GPU. Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels (zflac_tpu_torch/csrc) and the host scan
library from the checkout's sources, then:

  1. prints the card (nvidia-smi name and power limit), torch and CUDA;
  2. builds the kernels and the scan library, and times the build;
  3. makes the streams: the bench stream (bench.py's: 2**22 correlated
     stereo samples per channel, 16-bit, block 4096; cached in
     .bench_cache/) and every stereo corpus stream of <= 16 bits;
  4. holds each kernel (rice16, lpc2, packtail) bit for bit against its
     plain PyTorch version on the card, on every stream's real chunk
     sections and on seeded synthetic inputs, and times both at the
     bench chunk's shapes (CUDA events, median of 25 batches of
     back-to-back calls after warm-up);
  5. resets the launch counters, drives zflac_tpu_torch.decode_to_device
     over the bench stream, reads the counters (each kernel must have
     launched), and checks the PCM against the encoder's input and the
     native C++ decoder, with the stream MD5 verified; then the same
     for every corpus stream, the bench stream in 256-frame chunks,
     and a corrupted stream that must raise InvalidChecksum;
  6. times the device reconstruction of the bench chunk and the whole
     decode_to_device call.

Any failure raises, and the exit code is then not 0. With no CUDA
device it exits 1 before doing anything. The last lines are one JSON
object with a record per kernel, the nvidia-smi line, and
{"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import zflac_tpu_torch
from zflac_tpu import format as fmt
from zflac_tpu.bitio import BitReader
from zflac_tpu.encoder import EncoderConfig, encode
from zflac_tpu.errors import InvalidChecksum
from zflac_tpu.index.native_indexer import (decode_cpu_native,
                                            native_available, pack2_range)
from zflac_tpu.oracle import parse_metadata
from zflac_tpu.result import container_dtype
from zflac_tpu.testing import correlated_stereo, make_corpus
from zflac_tpu_torch import _kernels
from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct, lpc2_reconstruct_ref
from zflac_tpu_torch.ops.packtail import packtail, packtail_ref
from zflac_tpu_torch.ops.rice16 import (K2_ESCAPE, K2_INVALID,
                                        rice16_unpack_rows,
                                        rice16_unpack_rows_ref)
from zflac_tpu_torch.runtime import device as rt

BENCH_SAMPLES = 1 << 22
BENCH_BLOCK = 4096
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
REPS = 25

KERNELS = {
    # name -> (source in the repo, the Pallas kernel's entry it replaces)
    "rice16": ("zflac_tpu_torch/csrc/rice16.cu",
               "zflac_tpu/ops/rice16.py:231"),
    "lpc2": ("zflac_tpu_torch/csrc/lpc2.cu", "zflac_tpu/ops/lpc2.py:88"),
    "packtail": ("zflac_tpu_torch/csrc/packtail.cu",
                 "zflac_tpu/ops/packtail.py:54"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bench_stream() -> bytes:
    """bench.py's stream, from its cache file when present."""
    path = os.path.join(CACHE, f"bench_{BENCH_SAMPLES}_{BENCH_BLOCK}.flac")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    pcm = correlated_stereo(BENCH_SAMPLES, 16, seed=7)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=BENCH_BLOCK))
    os.makedirs(CACHE, exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
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
    the chunk's real sections. Returns the kernel inputs."""
    buf, geom = rt.chunk_to_torch(ck, dev)
    win = geom.sect(buf, "win", geom.W * geom.NGp).view(geom.W, geom.NGp)
    meta = geom.sect(buf, "meta", geom.NGp)
    diff.check("rice16", what,
               rice16_unpack_rows(win, meta, Ssort=geom.Ssort),
               rice16_unpack_rows_ref(win, meta, Ssort=geom.Ssort))
    rows_t = rt.residual_rows(buf, geom)
    lpc = rt.lpc_class_inputs(rows_t, buf, geom)
    for cname, args in lpc.items():
        diff.check("lpc2", f"{what} {cname}",
                   lpc2_reconstruct(*args), lpc2_reconstruct_ref(*args))
    stack = rt.sorted_stack(rows_t, buf, geom)
    tail = rt.tail_inputs(buf, geom)
    cb = fmt.container_bits(ck.bits_per_sample)
    diff.check("packtail", what,
               packtail(stack, *tail, Fp=geom.Fp, container_bits=cb),
               packtail_ref(stack, *tail, Fp=geom.Fp, container_bits=cb))
    return dict(buf=buf, geom=geom, win=win, meta=meta, lpc=lpc,
                stack=stack, tail=tail, cb=cb)


def synthetic_checks(dev, diff: Diff) -> None:
    """Seeded inputs beyond what the streams reach: rice16 with W 8 and
    16 over random windows with escape, invalid and skip groups; lpc2
    with 15-bit coefficients (int32 wraparound) at hist 8/16/32 and
    padded block sizes; packtail over all four stereo modes, wasted
    bits and both containers."""
    rng = np.random.default_rng(2024)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    for W, Ssort, GP1 in ((8, 1024, 6), (16, 384, 5)):
        NG = GP1 * Ssort
        win = rng.integers(0, 1 << 32, (W, NG), dtype=np.uint32)
        k6 = rng.integers(0, 32, NG)
        k6[rng.random(NG) < 0.1] = K2_ESCAPE
        k6[rng.random(NG) < 0.1] = K2_INVALID
        meta = (rng.integers(0, 32, NG) | (k6 << 5)
                | (rng.integers(0, 32, NG) << 11)
                | (np.where(rng.random(NG) < 0.05,
                            rng.integers(0, 9, NG), 0) << 16))
        w_t, m_t = t(win.view(np.int32)), t(meta.astype(np.int32))
        diff.check("rice16", f"synthetic W={W}",
                   rice16_unpack_rows(w_t, m_t, Ssort=Ssort),
                   rice16_unpack_rows_ref(w_t, m_t, Ssort=Ssort))
    for hist, B in ((8, 640), (16, 1152), (32, 256)):
        n = 256
        order = rng.integers(1, hist + 1, n).astype(np.int32)
        cf = np.zeros((hist, n), np.int32)
        for i in range(n):
            cf[:order[i], i] = rng.integers(-(1 << 14), 1 << 14, order[i])
        args = (t(rng.integers(-(1 << 15), 1 << 15, (B, n)).astype(np.int32)),
                t(cf), t(rng.integers(0, 16, n).astype(np.int32)), t(order))
        diff.check("lpc2", f"synthetic hist={hist} B={B}",
                   lpc2_reconstruct(*args), lpc2_reconstruct_ref(*args))
    Fp, Bp, rows = 64, 384, 129
    for cb in (16, 8):
        args = (t(rng.integers(-(1 << 15), 1 << 15, (rows, Bp))
                  .astype(np.int32)),
                t(rng.integers(0, rows, 2 * Fp).astype(np.int32)),
                t(rng.integers(0, 5, 2 * Fp).astype(np.int32)),
                t(rng.choice([1, 8, 9, 10], Fp).astype(np.int32)))
        diff.check("packtail", f"synthetic container {cb}",
                   packtail(*args, Fp=Fp, container_bits=cb),
                   packtail_ref(*args, Fp=Fp, container_bits=cb))


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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        sys.exit(1)

    dev = torch.device("cuda", 0)
    line = gpu_line()
    say("device", f"{line} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.library()
    t1 = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native scan library did not build")
    t2 = time.perf_counter()
    say("build", f"CUDA kernels {t1 - t0:.1f} s (nvcc "
        f"{_kernels.find_nvcc()}, {' '.join(_kernels.NVCC_FLAGS)}); "
        f"host scan library {t2 - t1:.1f} s")

    t0 = time.perf_counter()
    bench = bench_stream()
    bench_want = expected_pcm(correlated_stereo(BENCH_SAMPLES, 16, seed=7),
                              16)
    corpus = {name: (data, expected_pcm(pcm, bps))
              for name, (data, pcm, _sr, bps) in make_corpus().items()
              if pcm.shape[1] == 2 and bps <= 16}
    say("streams", f"bench {len(bench)} B ({BENCH_SAMPLES} x 2 samples) "
        f"and {len(corpus)} stereo corpus streams of <= 16 bits, "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- kernels against their plain versions, on the card ----
    diff = Diff()
    ins = kernel_checks(dev, diff, "bench chunk", first_chunk(bench))
    # The chunks decode_to_device itself scans for the bench stream: one
    # per anchor-split range of the parallel scan, each of the
    # stream's 1024 frames at most.
    br = BitReader(bench)
    info = parse_metadata(br)
    main_chunks = rt.scan_pack2_chunks(
        bench, br.pos // 8, info, 1024, ins["geom"].Bp, False)
    for i, (_, ck) in enumerate(main_chunks):
        kernel_checks(dev, diff, f"bench range chunk {i}", ck)
    for name, (data, _) in corpus.items():
        kernel_checks(dev, diff, name, first_chunk(data))
    synthetic_checks(dev, diff)
    torch.cuda.synchronize()
    g = ins["geom"]
    say("kernels", f"bit-exact on the whole-stream bench chunk (Fp "
        f"{g.Fp}, Bp {g.Bp}, Ssort {g.Ssort}, W {g.W}, NGp {g.NGp}, "
        f"classes {g.classes}), the {len(main_chunks)} chunks of the "
        f"parallel scan (Ssort {[ck.Ssort for _, ck in main_chunks]}), "
        f"{len(corpus)} corpus chunks and synthetic inputs; max |err| "
        f"{diff.err}")

    win, meta, Ss = ins["win"], ins["meta"], g.Ssort
    lpc_args = next(iter(ins["lpc"].values()))
    tail = (ins["stack"], *ins["tail"])
    tkw = dict(Fp=g.Fp, container_bits=ins["cb"])
    timed = {
        "rice16": (lambda: rice16_unpack_rows(win, meta, Ssort=Ss),
                   lambda: rice16_unpack_rows_ref(win, meta, Ssort=Ss)),
        "lpc2": (lambda: lpc2_reconstruct(*lpc_args),
                 lambda: lpc2_reconstruct_ref(*lpc_args)),
        "packtail": (lambda: packtail(*tail, **tkw),
                     lambda: packtail_ref(*tail, **tkw)),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        say("kernels", f"{name} at bench shapes: kernel "
            f"{times[name][0]:.4f} ms, plain PyTorch {times[name][1]:.4f} "
            f"ms (per call, median of {REPS} batches, CUDA events) on "
            f"{line}")

    # ---- the main path, counted ----
    _kernels.launches.clear()
    dd = decode_check("bench stream", bench, bench_want)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    say("slice", f"bench stream: decode_to_device -> to_host (MD5 "
        f"verified) == encoder input == native decoder; chunks "
        f"{len(dd.chunks)}, frames {dd.stats['frames']}; kernel launches "
        f"{launches}")
    missing = [k for k in KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    for name, (data, want) in corpus.items():
        decode_check(name, data, want)
    say("slice", f"{len(corpus)} corpus streams bit-exact (to_host with "
        "MD5, interleaved_device, native decoder)")
    dd4 = decode_check("bench stream, chunk_frames=256", bench,
                       bench_want, chunk_frames=256)
    if len(dd4.chunks) < 2:
        raise AssertionError("chunk_frames=256 gave one chunk")
    say("slice", f"bench stream in {len(dd4.chunks)} chunks bit-exact")
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
    n_samples = BENCH_SAMPLES * 2
    buf, geom = ins["buf"], ins["geom"]
    rec_ms = cuda_ms(lambda: rt.reconstruct_pack2(
        buf, geom, container_bits=ins["cb"]))
    say("times", f"reconstruct_pack2, bench chunk from a device buffer: "
        f"{rec_ms:.4f} ms = {n_samples / rec_ms / 1e3:.1f} Msamples/s "
        f"(both channels; per call, median of {REPS} batches, CUDA "
        f"events) on {line}")
    walls, phases = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a = time.perf_counter()
        dd = zflac_tpu_torch.decode_to_device(bench, device="cuda")
        b = time.perf_counter()
        dd.synchronize()
        c = time.perf_counter()
        walls.append((c - a) * 1e3)
        phases.append(dict(dd.stats, wait_ms=(c - b) * 1e3))
    med = {k: statistics.median(p[k] for p in phases)
           for k in ("scan_ms", "rescan_ms", "enqueue_ms", "wait_ms")}
    e2e = statistics.median(walls)
    say("times", f"decode_to_device end to end (scan + H2D + device, "
        f"synchronized): {e2e:.3f} ms = {n_samples / e2e / 1e3:.1f} "
        f"Msamples/s, median of 5, host clock, {phases[0]['chunks']} "
        f"chunks, {os.cpu_count()} host cores; phase medians (host "
        f"clock) scan {med['scan_ms']:.3f} ms, union re-scan "
        f"{med['rescan_ms']:.3f} ms, upload + kernel queueing "
        f"{med['enqueue_ms']:.3f} ms, then waiting for the device "
        f"{med['wait_ms']:.3f} ms; on {line}")

    records = [{"name": k, "route": "cuda", "source": src,
                "replaces": rep, "launches": int(launches.get(k, 0)),
                "max_abs_err": diff.err[k], "ms": times[k][0],
                "plain_ms": times[k][1]}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": records}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
