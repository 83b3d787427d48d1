"""Build, bind and launch the port's CUDA kernels (csrc/*.cu).

The sources have a plain C interface (one `extern "C"` launcher per
kernel, no PyTorch headers), so nvcc builds them in seconds into one
shared library that ctypes loads, the way the host scan's
libzflac_index.so is loaded (index/native_indexer.py). The library is
built at first use into build/zflac_tpu_torch/ under the checkout, one
nvcc process per source started together and one link, and rebuilt
when any source is newer than it.

Every launch goes through `launch`: it makes the tensors' device the
current one for the call and restores the caller's afterwards (the C
launchers call cudaSetDevice and do not restore it), passes PyTorch's
current stream on that device, raises on the CUDA status the launcher
returns, and counts the launch in `launches` (kernel name -> count,
updated under the module's lock), which the smoke run reads to show
that the main path went through each kernel. Nothing is built or
loaded until a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zflac_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libzflac_tpu_torch.so")
PTXAS_REPORT = os.path.join(BUILD_DIR, "ptxas.txt")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# Kernel name -> (C launcher, argument types before (device, stream)).
_LAUNCHERS = {
    "rice16": ("zft_rice16_rows", (_P, _P, _P, _I, _I, _I)),
    # The flat layout is rice16's kernel with Ssort = NG, counted apart.
    "rice16_flat": ("zft_rice16_rows", (_P, _P, _P, _I, _I, _I)),
    "lpc": ("zft_lpc", (_P, _I, _P, _I, _P, _P, _P, _I, _I)),
    "lpc64": ("zft_lpc64", (_P, _I, _P, _I, _P, _P, _P, _I, _I)),
    "lpc2": ("zft_lpc2", (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I)),
    "lpc2w": ("zft_lpc2w", (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I)),
    "lpc2w33": ("zft_lpc2w33", (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I)),
    "packtail": ("zft_packtail", (_P, _I, _I, _P, _P, _P, _P, _I, _I)),
}

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default
    install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _run(cmds) -> list:
    """Run the commands at once; returns their stderr (ptxas -v writes
    its register and spill report there); raises with the stderr of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate(timeout=600) for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the shared library unless it is newer
    than every source and header: one nvcc per source, all started
    together, then one link. ptxas's register, shared-memory and spill
    report for every kernel goes to PTXAS_REPORT. Returns the library
    path; raises with nvcc's stderr when the build fails."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if not force and os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= max(map(os.path.getmtime, deps)):
        return _SO
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
            for s in srcs]
    report = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s]
                   for s, o in zip(srcs, objs)])
    tmp = f"{_SO}.{tag}"
    _run([[nvcc, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    with open(PTXAS_REPORT, "w") as f:
        f.write("".join(report))
    os.replace(tmp, _SO)
    return _SO


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for cname, argtypes in _LAUNCHERS.values():
                fn = getattr(lib, cname)
                fn.argtypes = [*argtypes, _I, _P]
                fn.restype = _I
            lib.zft_error_string.argtypes = [_I]
            lib.zft_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device, *args) -> None:
    """Launch kernel `name` on `device`'s current PyTorch stream with
    launcher arguments `args` (tensor data pointers and ints), raise on
    a CUDA error, and count the launch. The launcher switches the
    thread's CUDA device to `device`; the guard around it puts the
    caller's device back, so a decode on another card than the current
    one leaves the thread where it was."""
    import torch
    lib = library()
    cname, _ = _LAUNCHERS[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, cname)(*args, device.index, stream)
    if rc != 0:
        msg = lib.zft_error_string(rc).decode()
        raise RuntimeError(f"{cname}: CUDA error {rc} ({msg})")
    with _lock:
        launches[name] += 1


def route(*tensors) -> str:
    """'cpu' when every tensor lies on the CPU (the wrapper then runs
    its plain PyTorch version), 'cuda' when all lie on one CUDA device
    (the wrapper launches its kernel). Anything else raises: there is
    no fallback from one to the other."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"no kernel or plain version for device {dev}")


def check(t, name: str, dtype, shape=None, inner_contiguous=False) -> None:
    """Raise unless `t` has `dtype`, `shape` (when given) and a layout
    the kernel takes: fully contiguous, or with `inner_contiguous` a
    2-D view whose rows are contiguous (any row stride)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if inner_contiguous:
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1) or \
                t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: rows must be contiguous, strides "
                             f"{t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
