"""The SASS of the port's LPC ring kernels (csrc/lpc2.cu, lpc2w.cu and
lpc.cu), for reading the chain of one recurrence step. Run it on a
machine with nvcc and cuobjdump, from the root of a checkout:

    python3 -m zflac_tpu_torch.tools.kernel_sass [OUT_DIR]

It builds the kernel library (build/zflac_tpu_torch/), prints ptxas's
registers and spills for each instantiation, and writes the SASS of
every ring kernel instantiation (lpc2_kernel, lpc2w_kernel and
lpc2w33_kernel at hist 8/16/32, lpc_kernel at int32 and int64) to
OUT_DIR (default build/zflac_tpu_torch/sass/), one file each, with a
count by opcode of the instructions of each long loop body (a stage's
step groups; a kernel has one for each step form it holds) and the
instructions a step: the body's length over its stores, one STG a
step.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from .. import _kernels

# A ring kernel's mangled name: the kernel, then its hist (ILi8E) or
# its element type (IiE int32, IlE int64).
PATTERN = re.compile(
    r"(lpc2w33_kernel|lpc2w_kernel|lpc2_kernel|lpc_kernel)I(?:Li(\d+)|([il]))E")
_TYPES = {"i": "i32", "l": "i64"}


def kernel_name(mangled: str):
    """'lpc2w33_kernel_8', 'lpc_kernel_i64', ... for a ring kernel's
    mangled name, else None."""
    m = PATTERN.search(mangled)
    if not m:
        return None
    return f"{m.group(1)}_{m.group(2) or _TYPES[m.group(3)]}"


def functions(sass: str):
    """(name, SASS text) of each ring kernel in cuobjdump's output."""
    for part in sass.split("\t\tFunction : ")[1:]:
        name = kernel_name(part.split("\n", 1)[0])
        if name:
            yield name, part


def long_loops(text: str, least: int = 100):
    """Opcode counts of each backward branch's body (the instructions
    from the BRA's target to the BRA) of at least `least` instructions,
    innermost first: a loop that holds one already listed (a stage's
    loop around its step groups) is skipped."""
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
    for j, i in sorted(spans, key=lambda s: s[1] - s[0]):
        if any(j <= a and b <= i for a, b in out):
            continue
        out.append((j, i))
    for j, i in sorted(out):
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
                    if "lpc" in ln or "Used" in ln or "spill" in ln))
    cuobjdump = os.path.join(os.path.dirname(_kernels.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    for name, text in functions(sass):
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(text)
        for n, ops in long_loops(text):
            stg = sum(v for k, v in ops.items() if k.split(".")[0] == "STG")
            per = f", {n / stg:.1f} a step" if stg else ""
            print(f"{name}: loop of {n} instructions{per}: " + ", ".join(
                f"{k} {v}" for k, v in ops.most_common(16)))


if __name__ == "__main__":
    main()
