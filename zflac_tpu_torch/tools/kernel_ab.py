"""Another build of the streaming kernels, rice16 and packtail, loaded
beside this checkout's, so that the two can be timed on the same
inputs in one process (chip_smoke.py --compare-csrc CSRC, where CSRC is
another checkout's zflac_tpu_torch/csrc, say a `git archive` of the
parent commit unpacked under build/).

The C launchers zft_rice16_rows and zft_packtail keep one signature
across versions (_kernels._LAUNCHERS), so the other tree's rice16.cu
and packtail.cu build into a library that the same calls drive. The
calls here allocate the output and launch on PyTorch's current stream,
as the wrappers in ops/ do, and count nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import _kernels


def load(csrc: str, out_dir: str) -> ctypes.CDLL:
    """Build csrc's rice16.cu and packtail.cu into out_dir/libcompare.so
    (nvcc with _kernels.NVCC_FLAGS, one process per source) and load
    it with the launchers' argument types."""
    os.makedirs(out_dir, exist_ok=True)
    srcs = [os.path.join(csrc, s) for s in ("rice16.cu", "packtail.cu")]
    objs = [os.path.join(out_dir, os.path.basename(s) + ".o") for s in srcs]
    nvcc = _kernels.find_nvcc()
    _kernels._run([[nvcc, *_kernels.NVCC_FLAGS, "-c", "-o", o, s]
                   for s, o in zip(srcs, objs)])
    so = os.path.join(out_dir, "libcompare.so")
    _kernels._run([[nvcc, "-shared", "-o", so, *objs]])
    lib = ctypes.CDLL(so)
    for name in ("rice16", "packtail"):
        cname, argtypes = _kernels._LAUNCHERS[name]
        fn = getattr(lib, cname)
        fn.argtypes = [*argtypes, _kernels._I, _kernels._P]
        fn.restype = _kernels._I
    return lib


def _call(lib, cname: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, cname)(*args, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{cname} (compared build): CUDA error {rc}")


def rice16(lib, win, meta, Ssort: int):
    """The other build's rice16 on contiguous CUDA tensors win [W, NGp]
    and meta [NGp]: [(NGp // Ssort) * 8, Ssort] int32."""
    W, NGp = win.shape
    out = torch.empty((NGp // Ssort * 8, Ssort), dtype=torch.int32,
                      device=win.device)
    _call(lib, "zft_rice16_rows", win.device, win.data_ptr(),
          meta.data_ptr(), out.data_ptr(), W, NGp, Ssort)
    return out


def packtail(lib, stack, inv, wasted, chcode, *, Fp: int,
             container_bits: int):
    """The other build's packtail on contiguous CUDA tensors, shapes as
    ops.packtail.packtail: [Fp, Bp] int32 (container 16) or int16."""
    rows, Bp = stack.shape
    dtype = torch.int32 if container_bits == 16 else torch.int16
    out = torch.empty((Fp, Bp), dtype=dtype, device=stack.device)
    _call(lib, "zft_packtail", stack.device, stack.data_ptr(), rows, Bp,
          inv.data_ptr(), wasted.data_ptr(), chcode.data_ptr(),
          out.data_ptr(), Fp, container_bits)
    return out
