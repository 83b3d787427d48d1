"""Readings that the limits of `correct` are set from: for each seed, a
short run of the program (the lower reading) and of the control, the
float32 reference in the program's place (the upper reading), both
through the harness's own check at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 3]

On a machine with the card; prints one JSON line a seed and run. The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from harness import cell
    from harness.control import ControlEntry

    for seed in (int(s) for s in args.seeds.split(",")):
        for name, entry in (("program", None), ("control", ControlEntry())):
            res, _ = cell.run_cell(args.workload, seed, args.seconds, False,
                                   device="cuda", entry=entry)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": name, "correct": res["correct"],
                              "attempted": res["attempted"],
                              "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
