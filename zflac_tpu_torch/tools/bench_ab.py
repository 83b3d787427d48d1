"""A/B benchmark of the port's native scan engine: this checkout's
library against the one built from a git revision's sources
(counterpart of tools/bench_ab.py, the analog of the reference's zbench
harness, which times the current build against a pinned earlier
release of itself). Host only:

    python3 -m zflac_tpu_torch.tools.bench_ab [REV] [--corpus]

REV (default HEAD~1) is read with `git show` from the checkout's
repository: its zflac_tpu_torch/index/native/ sources are built with the
production flags into build/zflac_tpu_torch/bench_ab/<rev>/. Both
libraries then decode bench16 (tools/streams.py) with the parallel
engine and MD5 on, the work bench.py's baseline does, median of 9;
`--corpus` times every corpus stream instead. Prints one JSON line.
The older library is loaded with this checkout's Plan layout, so a
revision from before a layout change cannot be compared.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from ..index import native_indexer as ni
from . import streams

_NATIVE_SOURCES = ("indexer.cpp", "pack2_helpers.inc", "interleave.inc",
                   "simd512.inc")


def build_rev(rev: str) -> str:
    """The whole native engine (indexer.cpp and the .inc files it
    includes) at `rev`, built with the production flags."""
    out = os.path.join(os.path.dirname(ni.BUILD_DIR), "bench_ab",
                       re.sub(r"[^\w.-]", "_", rev))
    os.makedirs(out, exist_ok=True)
    for name in _NATIVE_SOURCES:
        try:
            blob = subprocess.check_output(
                ["git", "-C", streams.ROOT, "show",
                 f"{rev}:zflac_tpu_torch/index/native/{name}"],
                stderr=subprocess.DEVNULL)
        except subprocess.CalledProcessError:
            continue  # the revision predates this file
        with open(os.path.join(out, name), "wb") as f:
            f.write(blob)
    so = os.path.join(out, ni.LIB_NAME)
    subprocess.run(["g++", *ni.CXX_FLAGS, "-o", so,
                    os.path.join(out, "indexer.cpp")], check=True,
                   timeout=600)
    return so


def bench_so(path: str, data: bytes, reps: int = 9) -> float:
    """Median wall time of the full native decode (parallel engine,
    MD5 on)."""
    lib = ctypes.CDLL(path)
    lib.zfi_decode_parallel.restype = ctypes.c_int
    lib.zfi_decode_parallel.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ni._Plan), ctypes.POINTER(ctypes.c_void_p)]
    lib.zfi_free.argtypes = [ctypes.POINTER(ni._Plan)]
    lib.zfi_free_samples.argtypes = [ctypes.c_void_p]
    times = []
    for _ in range(reps):
        plan = ni._Plan()
        sp = ctypes.c_void_p()
        t = time.perf_counter()
        rc = lib.zfi_decode_parallel(data, len(data), 0, 1,
                                     ctypes.byref(plan), ctypes.byref(sp))
        times.append(time.perf_counter() - t)
        if rc != 0:
            raise RuntimeError(f"{path}: zfi_decode_parallel returned {rc}")
        lib.zfi_free(ctypes.byref(plan))
        lib.zfi_free_samples(sp)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rev", nargs="?", default="HEAD~1")
    ap.add_argument("--corpus", action="store_true",
                    help="time every corpus stream A/B (the reference's "
                    "per-file zbench protocol)")
    args = ap.parse_args(argv)
    rev = args.rev
    cur_so = ni.build()
    old_so = build_rev(rev)

    if args.corpus:
        from ..testing import make_corpus

        rows = []
        for name, (data, *_rest) in sorted(make_corpus().items()):
            t_cur = bench_so(cur_so, data, reps=5)
            t_old = bench_so(old_so, data, reps=5)
            rows.append({"file": name, "head_ms": t_cur * 1e3,
                         "rev_ms": t_old * 1e3, "speedup": t_old / t_cur})
            print(f"{name:32s} this {t_cur * 1e3:8.3f} ms   {rev} "
                  f"{t_old * 1e3:8.3f} ms   x{t_old / t_cur:.3f}")
        worst = min(rows, key=lambda r: r["speedup"])
        print(json.dumps({
            "metric": "native_decode_ab_corpus",
            "files": len(rows),
            "geomean_speedup": float(np.exp(np.mean(
                [np.log(r["speedup"]) for r in rows]))),
            "worst_speedup": worst["speedup"],
            "worst_file": worst["file"],
        }))
        return 0

    data = streams.bench_stream("bench16")
    t_cur = bench_so(cur_so, data)
    t_old = bench_so(old_so, data)
    print(json.dumps({
        "metric": "native_decode_ab",
        "head_ms": t_cur * 1e3,
        f"{rev}_ms": t_old * 1e3,
        "speedup": t_old / t_cur,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
