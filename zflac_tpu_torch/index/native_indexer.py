"""ctypes binding + on-demand build for the native C++ frame indexer
(index/native/indexer.cpp): the port's copy of
zflac_tpu/index/native_indexer.py, built from the port's copy of the
sources into build/zflac_tpu_torch/native/ under the checkout. It
produces the same StreamPlan as py_indexer.build_plan and the same
pack2 buffers as the JAX package's copy (tests/test_torch_host.py)."""

from __future__ import annotations

import ctypes
import fcntl
import os
import platform
import subprocess
import threading

import numpy as np

from .. import errors as err
from ..format import StreamInfo
from ..plan import StreamPlan

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
# indexer.cpp includes the three .inc files; all four decide freshness.
_SRCS = tuple(os.path.join(_NATIVE_DIR, f) for f in (
    "indexer.cpp", "pack2_helpers.inc", "interleave.inc", "simd512.inc"))
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "zflac_tpu_torch", "native")
LIB_NAME = "libzflac_index.so"
# c++20 + -fwrapv: left shift of negative values and signed overflow
# are defined two's-complement wraparound, exactly the wasted-bits,
# normalization and recurrence semantics the decoder needs on corrupt
# input (garbage values wrap, then the MD5/CRC checks reject the
# stream). -march=native ties the library to the host's CPU, so the
# stamp beside it names the CPU model it was built for.
CXX_FLAGS = ("-O3", "-march=native", "-std=c++20", "-fwrapv", "-shared",
             "-fPIC")

_lock = threading.Lock()
_lib = None
_build_failed = False

ERROR_MAP = {
    1: err.InvalidSignature,
    2: err.InvalidMetadataHeader,
    3: err.MissingStreaminfo,
    4: err.InvalidFrameHeader,
    5: err.InconsistentParameters,
    6: err.InvalidSubframeHeader,
    7: err.InvalidResidualCodingMethod,
    8: err.InvalidCodedNumber,
    9: err.InvalidChecksum,
    10: err.EndOfStream,
    11: err.Unimplemented,
}


class _Plan(ctypes.Structure):
    _fields_ = [
        ("min_block_size", ctypes.c_uint32),
        ("max_block_size", ctypes.c_uint32),
        ("min_frame_size", ctypes.c_uint32),
        ("max_frame_size", ctypes.c_uint32),
        ("si_sample_rate", ctypes.c_uint32),
        ("si_channels", ctypes.c_uint32),
        ("si_bits_per_sample", ctypes.c_uint32),
        ("si_total_samples", ctypes.c_uint64),
        ("md5", ctypes.c_uint8 * 16),
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("num_frames", ctypes.c_uint64),
        ("num_subframes", ctypes.c_uint64),
        ("max_block", ctypes.c_uint64),
        ("total_samples", ctypes.c_uint64),
        ("value_width", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("f_block_size", ctypes.POINTER(ctypes.c_int32)),
        ("f_channel_code", ctypes.POINTER(ctypes.c_int32)),
        ("f_pcm_start", ctypes.POINTER(ctypes.c_int64)),
        ("f_byte_offset", ctypes.POINTER(ctypes.c_int64)),
        ("rows", ctypes.c_void_p),
        ("kind", ctypes.POINTER(ctypes.c_int32)),
        ("order", ctypes.POINTER(ctypes.c_int32)),
        ("wasted", ctypes.POINTER(ctypes.c_int32)),
        ("shift", ctypes.POINTER(ctypes.c_int32)),
        ("coeffs_rev", ctypes.POINTER(ctypes.c_int32)),
        ("seeds", ctypes.c_void_p),
        ("wide", ctypes.POINTER(ctypes.c_uint8)),
        ("grp_off", ctypes.POINTER(ctypes.c_int64)),
        ("grp_k", ctypes.POINTER(ctypes.c_uint8)),
        ("grp_depth", ctypes.POINTER(ctypes.c_uint8)),
        ("grp_per_row", ctypes.c_int32),
        ("_pad2", ctypes.c_int32),
        ("f_coded_number", ctypes.POINTER(ctypes.c_int64)),
        ("variable_blocking", ctypes.c_int32),
        ("_pad3", ctypes.c_int32),
        ("sk_warm", ctypes.POINTER(ctypes.c_int32)),
        ("sk_patch_sub", ctypes.POINTER(ctypes.c_int32)),
        ("sk_patch_pos", ctypes.POINTER(ctypes.c_int32)),
        ("sk_patch_val", ctypes.POINTER(ctypes.c_int32)),
        ("sk_patch_n", ctypes.c_int64),
        ("skim", ctypes.c_int32),
        ("_pad4", ctypes.c_int32),
        ("computed_md5", ctypes.c_uint8 * 16),
        ("md5_state", ctypes.c_int32),
        ("_pad5", ctypes.c_int32),
    ]


class _Pack2(ctypes.Structure):
    """Mirror of struct Pack2 in index/native/pack2_helpers.inc."""
    _fields_ = [
        ("buf", ctypes.POINTER(ctypes.c_int32)),
        ("device_words", ctypes.c_int64),
        ("total_words", ctypes.c_int64),
        ("F", ctypes.c_int32), ("C", ctypes.c_int32),
        ("S", ctypes.c_int32), ("B", ctypes.c_int32),
        ("Fp", ctypes.c_int32), ("Sp", ctypes.c_int32),
        ("Bp", ctypes.c_int32), ("GPB", ctypes.c_int32),
        ("W", ctypes.c_int32), ("NGp", ctypes.c_int32),
        ("n_patch", ctypes.c_int32), ("n_patch_p", ctypes.c_int32),
        ("class_kind", ctypes.c_int32 * 8),
        ("class_n", ctypes.c_int32 * 8),
        ("class_np", ctypes.c_int32 * 8),
        ("n_classes", ctypes.c_int32), ("_pad0", ctypes.c_int32),
        ("off_win", ctypes.c_int64), ("off_meta", ctypes.c_int64),
        ("off_kind", ctypes.c_int64), ("off_order", ctypes.c_int64),
        ("off_wasted", ctypes.c_int64), ("off_shift", ctypes.c_int64),
        ("off_cfwd", ctypes.c_int64), ("off_seeds", ctypes.c_int64),
        ("off_warm", ctypes.c_int64), ("off_warmlen", ctypes.c_int64),
        ("off_bssub", ctypes.c_int64), ("off_chcode", ctypes.c_int64),
        ("off_pidx", ctypes.c_int64), ("off_pval", ctypes.c_int64),
        ("off_inv", ctypes.c_int64),
        ("Ssort", ctypes.c_int32), ("_pad_ss", ctypes.c_int32),
        ("off_f_bs", ctypes.c_int64), ("off_f_chcode", ctypes.c_int64),
        ("off_f_coded", ctypes.c_int64), ("off_f_start", ctypes.c_int64),
        ("landed", ctypes.c_int64),
        ("total_block_samples", ctypes.c_int64),
        ("sample_rate", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("do_decorrelate", ctypes.c_int32),
        ("variable_blocking", ctypes.c_int32),
        ("off_warm_hi", ctypes.c_int64),
        ("off_seeds_hi", ctypes.c_int64),
        ("off_pval_hi", ctypes.c_int64),
        ("wide", ctypes.c_int32), ("_pad1", ctypes.c_int32),
    ]


# Class ids emitted by emit_pack2 (pack2_helpers.inc), in order.
PACK2_CLASSES = ("const", "verbatim", "fixed", "lpc8", "lpc16", "lpc32")


class Pack2Chunk:
    """One packed device chunk: the int32 plan buffer plus the static
    geometry the jitted reconstruction needs. The native allocation is
    copied out and freed eagerly in the constructor (the buffer feeds
    a device_put immediately, so there is no reason to pin the native
    copy for the chunk's lifetime)."""

    def __init__(self, lib, p: _Pack2):
        self.buf = _as_array(p.buf, (int(p.total_words),), np.int32)
        self.device_words = int(p.device_words)
        self.F, self.C, self.S, self.B = p.F, p.C, p.S, p.B
        self.Fp, self.Sp, self.Bp = p.Fp, p.Sp, p.Bp
        self.GPB, self.W, self.NGp = p.GPB, p.W, p.NGp
        self.n_patch, self.n_patch_p = p.n_patch, p.n_patch_p
        self.classes = tuple(
            (PACK2_CLASSES[p.class_kind[i]], int(p.class_n[i]),
             int(p.class_np[i]))
            for i in range(p.n_classes))
        self.landed = int(p.landed)
        self.total_block_samples = int(p.total_block_samples)
        self.sample_rate = int(p.sample_rate)
        self.bits_per_sample = int(p.bits_per_sample)
        self.do_decorrelate = bool(p.do_decorrelate)
        self.variable_blocking = int(p.variable_blocking)
        self.wide = bool(p.wide)
        # Section offsets (int32 words into buf).
        self.off = {
            "win": int(p.off_win), "meta": int(p.off_meta),
            "kind": int(p.off_kind), "order": int(p.off_order),
            "wasted": int(p.off_wasted), "shift": int(p.off_shift),
            "cfwd": int(p.off_cfwd), "seeds": int(p.off_seeds),
            "warm": int(p.off_warm), "warmlen": int(p.off_warmlen),
            "bssub": int(p.off_bssub), "chcode": int(p.off_chcode),
            "pidx": int(p.off_pidx), "pval": int(p.off_pval),
            "inv": int(p.off_inv),
        }
        if self.wide:
            # 33-bit side-channel chunks: hi-word sections for the
            # 64-bit pair reconstruction (runtime/wide.py).
            self.off["warm_hi"] = int(p.off_warm_hi)
            self.off["seeds_hi"] = int(p.off_seeds_hi)
            self.off["pval_hi"] = int(p.off_pval_hi)
        self.Ssort = int(p.Ssort)
        # Host-only frame table views.
        self.f_block_size = self.buf[
            p.off_f_bs:p.off_f_bs + p.F].copy()
        self.f_channel_code = self.buf[
            p.off_f_chcode:p.off_f_chcode + p.F].copy()
        self.f_coded_number = self.buf[
            p.off_f_coded:p.off_f_coded + 2 * p.F].view(np.int64).copy()
        self.f_byte_offset = self.buf[
            p.off_f_start:p.off_f_start + 2 * p.F].view(np.int64).copy()
        lib.zfi_pack2_free(ctypes.byref(p))

    @property
    def device_buf(self) -> np.ndarray:
        """The upload slice (plan sections; excludes the host tail)."""
        return self.buf[:self.device_words]

    def spec_key(self):
        """Static jit key: geometry + section layout."""
        return (self.Fp, self.Sp, self.Bp, self.GPB, self.W, self.NGp,
                self.n_patch_p, self.C,
                tuple((n, np_) for n, _, np_ in self.classes),
                tuple(sorted(self.off.items())))


def pack2_range(data: bytes, start_byte: int, stop_byte: int,
                info: StreamInfo, check_crc: bool = False,
                max_frames: int = 0, force_fp: int = 0,
                force_bp: int = 0, force_w: int = 0,
                force_class_np=None, force_patch_np: int = 0,
                force_wide: bool = False):
    """Measure-only scan of whole frames in [start_byte, stop_byte)
    emitting the packed device buffer (pack2 fast path). Returns a
    Pack2Chunk, or None when the fast path declines for ANY reason —
    unsupported geometry or a mid-scan parse error (the caller falls
    back to the general engine, which either decodes the stream or
    raises the typed error with exact reference semantics)."""
    lib = _load()
    if lib is None:
        return None
    p = _Pack2()
    if force_class_np is not None:
        cnp = np.asarray(force_class_np, dtype=np.int32)
        assert cnp.shape == (6,)
        cnp_ptr = cnp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    else:
        cnp_ptr = None
    rc = lib.zfi_pack2_range(
        data, len(data), start_byte, stop_byte, max_frames,
        info.sample_rate, info.bits_per_sample, info.channel_count,
        1 if check_crc else 0, force_fp, force_bp, force_w,
        cnp_ptr, force_patch_np, 1 if force_wide else 0,
        ctypes.byref(p))
    if rc in (100, 101):
        return None
    if rc != 0:
        # Any scan error declines the fast path: the general engine may
        # still decode the stream (e.g. trailing non-frame bytes past
        # the STREAMINFO total, which the sequential drivers never
        # reach), and if the stream is truly malformed the fallback
        # engine raises the typed error with exact reference semantics.
        if p.buf:
            lib.zfi_pack2_free(ctypes.byref(p))
        return None
    return Pack2Chunk(lib, p)


def _cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo (the machine name
    where that file is missing)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def _stamp() -> str:
    return f"g++ {' '.join(CXX_FLAGS)}\ncpu {_cpu_model()}\n"


def _fresh(so: str) -> bool:
    """The library at `so` is newer than every source and its stamp
    names these flags and this host's CPU."""
    try:
        if os.path.getmtime(so) < max(map(os.path.getmtime, _SRCS)):
            return False
        with open(so + ".stamp") as f:
            return f.read() == _stamp()
    except OSError:
        return False


def build(build_dir: str = BUILD_DIR, force: bool = False) -> str:
    """Compile the scan library into `build_dir` unless it is fresh
    (or `force`). Returns its path; raises with g++'s stderr when the
    build fails.

    Processes that build at once take turns on a lock file, so one
    compiles and the others find its result. g++ writes a temporary
    file that is renamed into place, so no process loads a half-written
    library."""
    so = os.path.join(build_dir, LIB_NAME)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _fresh(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SRCS[0]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
        with open(tmp, "w") as f:
            f.write(_stamp())
        os.replace(tmp, so + ".stamp")
    return so


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the library's entry
    points; returns `lib`."""
    lib.zfi_index_ex.restype = ctypes.c_int
    lib.zfi_index_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Plan), ctypes.POINTER(ctypes.c_int64)]
    lib.zfi_free.restype = None
    lib.zfi_free.argtypes = [ctypes.POINTER(_Plan)]
    lib.zfi_decode_cpu.restype = ctypes.c_int
    lib.zfi_decode_cpu.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Plan),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.zfi_decode_parallel.restype = ctypes.c_int
    lib.zfi_decode_parallel.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Plan), ctypes.POINTER(ctypes.c_void_p)]
    lib.zfi_free_samples.restype = None
    lib.zfi_free_samples.argtypes = [ctypes.c_void_p]
    lib.zfi_find_anchor.restype = ctypes.c_int64
    lib.zfi_find_anchor.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    lib.zfi_index_range.restype = ctypes.c_int
    lib.zfi_index_range.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.POINTER(_Plan), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    lib.zfi_pack2_range.restype = ctypes.c_int
    lib.zfi_pack2_range.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(_Pack2)]
    lib.zfi_pack2_free.restype = None
    lib.zfi_pack2_free.argtypes = [ctypes.POINTER(_Pack2)]
    return lib


def _load():
    """The bound library, built at first use; None when it cannot be
    built or loaded (the callers then decline, as in the JAX
    package)."""
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            try:
                _lib = bind(ctypes.CDLL(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _build_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def _as_array(ptr, shape, dtype):
    if np.prod(shape) == 0:
        return np.zeros(shape, dtype=dtype)
    n = int(np.prod(shape))
    buf = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype))),
        shape=(n,))
    return buf.reshape(shape).copy()


def build_plan_native(data: bytes, check_crc: bool = False,
                      emit_groups: bool = False) -> StreamPlan:
    """emit_groups: also record the Rice-group offset table consumed by
    the JAX package's bit-unpack kernel (zflac_tpu/ops/rice.py)."""
    lib = _load()
    assert lib is not None
    plan = _Plan()
    err_pos = ctypes.c_int64(0)
    rc = lib.zfi_index_ex(data, len(data), int(check_crc),
                          int(emit_groups), ctypes.byref(plan),
                          ctypes.byref(err_pos))
    if rc != 0:
        msg = "frame CRC mismatch" if rc == 9 else ""
        raise ERROR_MAP.get(rc, err.Unimplemented)(msg)
    try:
        info = StreamInfo(
            min_block_size=plan.min_block_size,
            max_block_size=plan.max_block_size,
            min_frame_size=plan.min_frame_size,
            max_frame_size=plan.max_frame_size,
            sample_rate=plan.si_sample_rate,
            channel_count=plan.si_channels,
            bits_per_sample=plan.si_bits_per_sample,
            total_samples=plan.si_total_samples,
            md5=bytes(bytearray(plan.md5)),
        )
        return _plan_to_streamplan(plan, info)
    finally:
        lib.zfi_free(ctypes.byref(plan))


def find_anchor(data: bytes, from_byte: int, limit_byte: int,
                info: StreamInfo) -> int:
    """Frame-resync: byte offset of the first fully-validated frame
    (structural parse + CRC-16) in [from_byte, limit_byte), or -1."""
    lib = _load()
    assert lib is not None
    return int(lib.zfi_find_anchor(
        data, len(data), from_byte, limit_byte, info.sample_rate,
        info.bits_per_sample))


def index_range(data: bytes, start_byte: int, stop_byte: int,
                info: StreamInfo, check_crc: bool = False,
                partial_ok: bool = False):
    """Index whole frames in [start_byte, stop_byte). Returns
    (StreamPlan shard, landed_byte). pcm_start offsets are shard-local;
    the caller globalizes them after the boundary exchange."""
    lib = _load()
    assert lib is not None
    plan = _Plan()
    plan.si_sample_rate = info.sample_rate
    plan.si_channels = info.channel_count
    plan.si_bits_per_sample = info.bits_per_sample
    plan.si_total_samples = info.total_samples
    landed = ctypes.c_int64(-1)
    rc = lib.zfi_index_range(data, len(data), start_byte, stop_byte,
                             ctypes.byref(plan), int(check_crc),
                             ctypes.byref(landed))
    try:
        if rc != 0 and not partial_ok:
            msg = "frame CRC mismatch" if rc == 9 else ""
            raise ERROR_MAP.get(rc, err.Unimplemented)(msg)
        sp = _plan_to_streamplan(plan, info)
        if partial_ok:
            exc = (ERROR_MAP.get(rc, err.Unimplemented)()
                   if rc != 0 else None)
            return sp, int(landed.value), exc
        return sp, int(landed.value)
    finally:
        lib.zfi_free(ctypes.byref(plan))


def _plan_to_streamplan(plan, info: StreamInfo) -> StreamPlan:
    S = int(plan.num_subframes)
    F = int(plan.num_frames)
    B = int(plan.max_block)
    vdtype = np.int32 if plan.value_width == 4 else np.int64
    skim = bool(plan.skim)
    sp = StreamPlan(
        info=info,
        sample_rate=int(plan.sample_rate),
        channels=int(plan.channels),
        bits_per_sample=int(plan.bits_per_sample),
        block_size=_as_array(plan.f_block_size, (F,), np.int32),
        channel_code=_as_array(plan.f_channel_code, (F,), np.int32),
        pcm_start=_as_array(plan.f_pcm_start, (F,), np.int64),
        frame_byte_offset=_as_array(plan.f_byte_offset, (F,), np.int64),
        coded_number=_as_array(plan.f_coded_number, (F,), np.int64),
        variable_blocking=bool(plan.variable_blocking),
        rows=None if skim else _as_array(plan.rows, (S, B), vdtype),
        kind=_as_array(plan.kind, (S,), np.int32),
        order=_as_array(plan.order, (S,), np.int32),
        wasted=_as_array(plan.wasted, (S,), np.int32),
        shift=_as_array(plan.shift, (S,), np.int32),
        coeffs_rev=_as_array(plan.coeffs_rev, (S, 32), np.int32),
        fixed_seeds=_as_array(plan.seeds, (S, 4), vdtype),
        wide=_as_array(plan.wide, (S,), np.uint8).astype(bool),
        total_samples=int(plan.total_samples),
        stats={"frames": F, "indexer": "native"},
        max_block_v=B,
    )
    if plan.grp_per_row:
        gpb = int(plan.grp_per_row)
        sp.groups = {
            "off": _as_array(plan.grp_off, (S, gpb), np.int64),
            "k": _as_array(plan.grp_k, (S, gpb), np.uint8),
            "depth": _as_array(plan.grp_depth, (S, gpb), np.uint8),
        }
    if skim:
        P = int(plan.sk_patch_n)
        sp.warmups = _as_array(plan.sk_warm, (S, 32), np.int32)
        sp.patches = (
            _as_array(plan.sk_patch_sub, (P,), np.int32),
            _as_array(plan.sk_patch_pos, (P,), np.int32),
            _as_array(plan.sk_patch_val, (P,), np.int32),
        )
    return sp


def decode_native_parallel(data: bytes, check_crc: bool = False,
                           compute_md5: bool = True):
    """One-call native decode: parallel (sync-scan) indexing + threaded
    reconstruction. The production host path for host-destined output.
    Returns (interleaved pre-normalization container samples, meta).
    compute_md5: hash the output inline (overlapped with decode) and
    report the digest via meta["computed_md5"] (None if not computed).

    The returned array *borrows* the C buffer (no copy); a finalizer
    frees it when the array is collected."""
    import weakref

    lib = _load()
    assert lib is not None
    plan = _Plan()
    samples_ptr = ctypes.c_void_p()
    rc = lib.zfi_decode_parallel(data, len(data), int(check_crc),
                                 int(compute_md5), ctypes.byref(plan),
                                 ctypes.byref(samples_ptr))
    try:
        if rc != 0:
            lib.zfi_free_samples(samples_ptr)
            msg = "frame CRC mismatch" if rc == 9 else ""
            raise ERROR_MAP.get(rc, err.Unimplemented)(msg)
        from ..format import container_bits
        cb = container_bits(int(plan.si_bits_per_sample))
        n = int(plan.total_samples) * int(plan.channels)
        dtype = {8: np.int8, 16: np.int16, 32: np.int32}[cb]
        if n == 0 or not samples_ptr.value:
            arr = np.zeros(n, dtype=dtype)
            lib.zfi_free_samples(samples_ptr)
        else:
            ctype = np.ctypeslib.as_ctypes_type(dtype)
            cbuf = (ctype * n).from_address(samples_ptr.value)
            arr = np.frombuffer(cbuf, dtype=dtype)
            # np.frombuffer keeps `cbuf` alive via arr.base; free the C
            # allocation when the view is garbage-collected.
            weakref.finalize(cbuf, lib.zfi_free_samples,
                             ctypes.c_void_p(samples_ptr.value))
        meta = {
            "channels": int(plan.channels),
            "sample_rate": int(plan.sample_rate),
            "bits_per_sample": int(plan.bits_per_sample),
            "si_bits_per_sample": int(plan.si_bits_per_sample),
            "md5": bytes(bytearray(plan.md5)),
            "computed_md5": bytes(bytearray(plan.computed_md5))
            if plan.md5_state == 1 else None,
            "frames": int(plan.num_frames),
        }
        return arr, meta
    finally:
        lib.zfi_free(ctypes.byref(plan))


def decode_cpu_native(data: bytes):
    """Full single-threaded scalar decode in C++ (the measured CPU
    baseline per BASELINE.md, and a host fallback path). Returns
    (interleaved pre-normalization container samples, meta dict)."""
    lib = _load()
    assert lib is not None
    plan = _Plan()
    samples_ptr = ctypes.c_void_p()
    rc = lib.zfi_decode_cpu(data, len(data), ctypes.byref(plan),
                            ctypes.byref(samples_ptr))
    if rc != 0:
        raise ERROR_MAP.get(rc, err.Unimplemented)()
    try:
        n = int(plan.total_samples) * int(plan.channels)
        dtype = {1: np.int8, 2: np.int16, 4: np.int32}[plan.value_width]
        arr = _as_array(samples_ptr, (n,), dtype)
        meta = {
            "channels": int(plan.channels),
            "sample_rate": int(plan.sample_rate),
            "bits_per_sample": int(plan.bits_per_sample),
            "si_bits_per_sample": int(plan.si_bits_per_sample),
            "md5": bytes(bytearray(plan.md5)),
            "frames": int(plan.num_frames),
        }
        return arr, meta
    finally:
        lib.zfi_free_samples(samples_ptr)
