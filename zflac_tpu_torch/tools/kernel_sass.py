"""The SASS of the port's kernels, for reading what a thread issues.
Run it on a machine with nvcc and cuobjdump, from the root of a
checkout:

    python3 -m zflac_tpu_torch.tools.kernel_sass [OUT_DIR] [--compare CSRC]

It builds the kernel library (build/zflac_tpu_torch/), prints ptxas's
registers and spills for each instantiation, and writes the SASS of
every ring kernel instantiation (lpc2_kernel, lpc2w_kernel and
lpc2w33_kernel at hist 8/16/32, lpc_kernel at int32 and int64) to
OUT_DIR (default build/zflac_tpu_torch/sass/), one file each, with a
count by opcode of the instructions of each long loop body (a stage's
step groups; a kernel has one for each step form it holds) and the
instructions a step: the body's length over its stores, one STG a
step.

Then the streaming kernels, rice16 (rice16_rows_kernel at W 8 and 16)
and packtail (packtail_kernel at containers 16 and 8), compiled from
this checkout's csrc/ and, with --compare, from another source
directory too (say a checkout of the parent commit's
zflac_tpu_torch/csrc): for each instantiation its registers and
spills, its instructions, and the instructions a residual (rice16) or
a sample (packtail): the body of its longest loop without the loops
nested in it (for a kernel with no loop, the whole function) over the
outputs it stores (counted from its stores' widths), every path of
the body counted; and the body's straight runs, cut after every
branch, that store, each as its instructions over its outputs, and
the longest of them a residual or sample. Where a kernel
holds one path for each kind of input (rice16: invalid, escaped and
Rice groups), each path is a run, and the instructions outside the
runs (a slot's set-up, the copies, the barriers) are not counted.
"""

from __future__ import annotations

import argparse
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


def sass_lines(text: str) -> list:
    """(address, instruction) of each instruction of a cuobjdump
    listing."""
    return re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)


def opcode(ins: str) -> str:
    """The opcode of an instruction, without its predicate."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loops(lines):
    """(first, last) indices of each backward branch's body."""
    at = {int(a, 16): i for i, (a, _) in enumerate(lines)}
    for i, (_addr, ins) in enumerate(lines):
        tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if tgt and at.get(int(tgt.group(1), 16), i) < i:
            yield at[int(tgt.group(1), 16)], i


def long_loops(text: str, least: int = 100):
    """Opcode counts of each backward branch's body (the instructions
    from the BRA's target to the BRA) of at least `least` instructions,
    innermost first: a loop that holds one already listed (a stage's
    loop around its step groups) is skipped."""
    lines = sass_lines(text)
    spans = [(j, i) for j, i in loops(lines) if i - j >= least]
    out = []
    for j, i in sorted(spans, key=lambda s: s[1] - s[0]):
        if any(j <= a and b <= i for a, b in out):
            continue
        out.append((j, i))
    for j, i in sorted(out):
        ops = collections.Counter(opcode(ins) for _, ins in lines[j:i + 1])
        yield i - j + 1, ops


# A streaming kernel's mangled name: the kernel and its template
# argument (W for rice16, the container for packtail); bytes an output
# element takes.
STREAMING = re.compile(r"(rice16_rows_kernel|packtail_kernel)ILi(\d+)E")


def out_bytes(kernel: str, arg: int) -> int:
    return 2 if kernel == "packtail_kernel" and arg == 8 else 4


def store_bytes(op: str) -> int:
    """Bytes one STG of opcode `op` (STG.E.128, STG.E.EF.U16, ...)
    writes."""
    for tag, n in ((".128", 16), (".64", 8), ("16", 2), ("8", 1)):
        if tag in op:
            return n
    return 4


def store_runs(text: str, item_bytes: int) -> tuple:
    """(instructions of the function, of the counted body, [(instructions,
    outputs stored)] of each straight run that stores). The body is the
    longest loop's body without the loops nested in it (the whole
    function when it has no loop); the runs are the body cut after
    every branch: where a
    kernel holds one path for each kind of input, each path is a run.
    NOPs are not counted."""
    lines = [(a, ins) for a, ins in sass_lines(text)
             if not ins.strip().startswith("NOP")]
    spans = sorted(set(loops(lines)), key=lambda s: s[0] - s[1])
    first, last = spans[0] if spans else (0, len(lines) - 1)
    inner = [(a, b) for a, b in spans[1:] if first <= a and b <= last
             and (a, b) != (first, last)]
    runs, run, body = [], [], 0
    for i in range(first, last + 1):
        if any(a <= i <= b for a, b in inner):
            continue
        op = opcode(lines[i][1])
        body += 1
        run.append(op)
        if op.split(".")[0] in ("BRA", "EXIT") or i == last:
            outs = sum(store_bytes(o) for o in run
                       if o.split(".")[0] == "STG") / item_bytes
            if outs:
                runs.append((len(run), outs))
            run = []
    return len(lines), body, runs


def streaming_report(csrc: str, label: str, out_dir: str) -> None:
    """rice16.cu and packtail.cu from `csrc` compiled to cubins: ptxas's
    registers and spills and the SASS counts of per_output for each
    instantiation."""
    nvcc = _kernels.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for src in ("rice16.cu", "packtail.cu"):
        cubin = os.path.join(out_dir, f"{label}_{src}.cubin")
        ptxas = subprocess.run(
            [nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
             cubin, os.path.join(csrc, src)],
            capture_output=True, text=True, check=True).stderr
        usage = {}
        for part in ptxas.split("Compiling entry function")[1:]:
            m = STREAMING.search(part.split("\n", 1)[0])
            if m:
                usage[m.group(0)] = "; ".join(
                    ln.split(" : ")[-1].strip() for ln in part.splitlines()
                    if "Used" in ln or "spill" in ln)
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
        for part in sass.split("\t\tFunction : ")[1:]:
            m = STREAMING.search(part.split("\n", 1)[0])
            if not m:
                continue
            kernel, arg = m.group(1), int(m.group(2))
            name = f"{kernel}_{arg}"
            with open(os.path.join(out_dir, f"{label}_{name}.sass"), "w") as f:
                f.write(part)
            total, body, runs = store_runs(part, out_bytes(kernel, arg))
            what = "residual" if kernel.startswith("rice16") else "sample"
            outs = sum(b for _, b in runs)
            n, k = max(runs)
            print(f"{name} ({label}, {csrc}): {usage.get(m.group(0), '')}; "
                  f"{total} instructions; loop body {body}, all paths, "
                  f"storing {outs:g} {what}s: {body / outs:.1f} a {what}; "
                  f"its straight runs that store (instructions / {what}s): "
                  + ", ".join(f"{a}/{b:g}" for a, b in runs)
                  + f", the longest {n / k:.1f} a {what}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(_kernels.BUILD_DIR, "sass"))
    ap.add_argument("--compare", metavar="CSRC",
                    help="another csrc directory whose rice16.cu and "
                    "packtail.cu are reported beside this checkout's")
    args = ap.parse_args()
    out_dir = args.out_dir
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
    streaming_report(_kernels.CSRC, "this", out_dir)
    if args.compare:
        streaming_report(os.path.abspath(args.compare), "compare", out_dir)


if __name__ == "__main__":
    main()
