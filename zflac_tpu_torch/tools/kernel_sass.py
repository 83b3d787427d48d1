"""The SASS of the port's LPC ring kernels (csrc/lpc2.cu and
lpc2w.cu), for reading the chain of one recurrence step. Run it on a
machine with nvcc and cuobjdump, from the root of a checkout:

    python3 -m zflac_tpu_torch.tools.kernel_sass [OUT_DIR]

It builds the kernel library (build/zflac_tpu_torch/), prints ptxas's
registers and spills for each instantiation, and writes the SASS of
every lpc2_kernel and lpc2w_kernel instantiation to OUT_DIR (default
build/zflac_tpu_torch/sass/), one file each, with a count by opcode of
the instructions of each long loop body (a stage's step groups; lpc2w
has one for each of its two step forms).
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from .. import _kernels

PATTERN = re.compile(r"(lpc2w?_kernel)ILi(\d+)E")


def functions(sass: str):
    """(name, SASS text) of each ring kernel in cuobjdump's output."""
    for part in sass.split("\t\tFunction : ")[1:]:
        m = PATTERN.search(part.split("\n", 1)[0])
        if m:
            yield f"{m.group(1)}_{m.group(2)}", part


def long_loops(text: str, least: int = 200):
    """Opcode counts of each backward branch's body (the instructions
    from the BRA's target to the BRA) of at least `least`
    instructions, outermost first; a loop nested in one already listed
    is skipped."""
    lines = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)
    at = {int(a, 16): i for i, (a, _) in enumerate(lines)}
    spans = []
    for i, (_addr, ins) in enumerate(lines):
        tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if tgt and int(tgt.group(1), 16) in at:
            j = at[int(tgt.group(1), 16)]
            if i - j >= least:
                spans.append((j, i))
    out = []
    for j, i in sorted(spans, key=lambda s: s[0] - s[1]):
        if any(a <= j and i <= b for a, b in out):
            continue
        out.append((j, i))
    for j, i in out:
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
            for _, ins in lines[j:i + 1])
        yield i - j + 1, ops


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        _kernels.BUILD_DIR, "sass")
    so = _kernels.build(force=True)
    with open(_kernels.PTXAS_REPORT) as f:
        report = f.read()
    print("\n".join(ln for ln in report.splitlines()
                    if "lpc2" in ln or "Used" in ln or "spill" in ln))
    cuobjdump = os.path.join(os.path.dirname(_kernels.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    for name, text in functions(sass):
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(text)
        for n, ops in long_loops(text):
            print(f"{name}: loop of {n} instructions: " + ", ".join(
                f"{k} {v}" for k, v in ops.most_common(16)))


if __name__ == "__main__":
    main()
