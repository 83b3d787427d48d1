"""The checked second pass of the port (counterpart of
tools/sanitize_run.py): the host code against the scan library built
with AddressSanitizer and UndefinedBehaviorSanitizer, and, with
`--card`, the fuzz on the card under compute-sanitizer's memcheck.

    python3 -m zflac_tpu_torch.tools.sanitize_run [--fuzz-iters N]
        [--skip-pytest] [--sanitize asan,ubsan] [--card]

An ASan-instrumented shared object loads only into a process that
already holds the ASan runtime, so each step runs in a new python with
LD_PRELOAD of libasan and libstdc++ and ZFLAC_TPU_SANITIZE set (the
scan library then builds -O1 with the sanitizers into a file of its own
under build/zflac_tpu_torch/native/). The host steps run on the CPU:

  * pytest tests/test_torch_faulty.py tests/test_torch_seek_pipelined.py
    tests/test_torch_host.py (typed errors, seek and tolerant decode,
    the scan against the JAX package's; these import the JAX package,
    so they run where it is installed; --skip-pytest leaves them out);
  * python3 -m zflac_tpu_torch.tools.fuzz_native --device cpu.

`--card` then runs the fuzz on the card (`--device cuda`, the
production scan library) under `compute-sanitizer --tool memcheck`
from the CUDA toolkit. Exit code 0 means that every step passed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from ..index.native_indexer import SANITIZE_ENV
from .streams import ROOT

TESTS = ("tests/test_torch_faulty.py", "tests/test_torch_seek_pipelined.py",
         "tests/test_torch_host.py")
# Seconds any one step may take.
STEP_TIMEOUT = 3600


def preload() -> str:
    """libasan + libstdc++: the ASan runtime must come first in the
    process, and libstdc++ must already be resident when ASan's
    __cxa_throw interceptor initializes (the engine reports errors as
    C++ exceptions), else the interceptor check-fails on first throw."""
    libs = []
    for name in ("libasan.so", "libstdc++.so"):
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True, check=True)
        path = out.stdout.strip()
        if not os.path.isabs(path):
            raise RuntimeError(f"{name} not found")
        libs.append(path)
    return " ".join(libs)


def compute_sanitizer() -> str:
    """The CUDA toolkit's compute-sanitizer."""
    for path in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("compute-sanitizer not found")


def steps(args) -> list:
    """(label, command, environment) of each step."""
    host = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    host[SANITIZE_ENV] = args.sanitize
    if "asan" in args.sanitize:
        host["LD_PRELOAD"] = preload()
        # detect_leaks off: CPython's interned one-time allocations
        # drown the report; the engine's buffers are exercised and
        # freed thousands of times below, so use-after-free and
        # out-of-bounds access stay armed.
        host["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
    host["UBSAN_OPTIONS"] = "print_stacktrace=1:halt_on_error=1"
    fuzz = [sys.executable, "-m", "zflac_tpu_torch.tools.fuzz_native",
            "--iters", str(args.fuzz_iters)]
    out = []
    if not args.skip_pytest:
        out.append(("host tests", [sys.executable, "-m", "pytest", *TESTS,
                                   "-q", "-p", "no:cacheprovider"], host))
    out.append(("host fuzz", [*fuzz, "--device", "cpu"], host))
    if args.card:
        card = {k: v for k, v in os.environ.items()
                if k not in (SANITIZE_ENV, "LD_PRELOAD")}
        card["PYTHONPATH"] = ROOT
        out.append(("card fuzz", [compute_sanitizer(), "--tool", "memcheck",
                                  "--error-exitcode", "1", *fuzz,
                                  "--device", "cuda"], card))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fuzz-iters", type=int, default=200)
    ap.add_argument("--skip-pytest", action="store_true")
    ap.add_argument("--sanitize", default="asan,ubsan")
    ap.add_argument("--card", action="store_true",
                    help="also run the fuzz on the card under "
                    "compute-sanitizer --tool memcheck")
    args = ap.parse_args(argv)
    for label, cmd, env in steps(args):
        print(f"[sanitize_run] {label}: {' '.join(cmd)}", flush=True)
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env,
                                timeout=STEP_TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            rc = 124
        if rc != 0:
            print(f"[sanitize_run] {label} FAILED rc={rc}", flush=True)
            return rc
    print("[sanitize_run] every step passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
