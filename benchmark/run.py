"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs a CUDA card: without one, or with
fewer cards than the cell asks for, it exits 2 and prints no result.
With --trace 0 the last line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a torch.profiler trace of the
window. The numbers compared with the reference are the last lines of
standard error and the result's last key, `checks`. A run that finds
JAX or the JAX package loaded once the window has closed exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

FORBIDDEN = ("jax", "jaxlib", "flax", "zflac_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`zflac_tpu_torch` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell as cell_mod, manifest

    want = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"{args.workload} needs {want} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = cell_mod.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print("loaded in the measuring process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
