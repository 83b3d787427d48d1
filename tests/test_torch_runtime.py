"""The PyTorch port's pack2 runtime (zflac_tpu_torch.runtime.device)
piece by piece, on the CPU: the stages between the kernels equal the
JAX core truncated at the same point, wide chunks equal the JAX wide
path, the buffer upload round-trips, the stop cut and corruption behave
as in the JAX package, the stream MD5 check equals the JAX one, the
kernel wrappers never fall back from a CUDA request to the CPU, the
entry points default to the card, and the port never imports JAX or the
JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu.index.native_indexer import (  # noqa: E402
    native_available,
    pack2_range,
)

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import _kernels  # noqa: E402
from zflac_tpu_torch.errors import InvalidChecksum  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _first_chunk(data, **kw):
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info, **kw)
    assert ck is not None
    return ck


def test_apply_stop_cut():
    bs = [np.array([4, 4]), np.array([4, 4])]
    assert rt.apply_stop_cut(bs, 8) == (1, 0, 8)
    assert rt.apply_stop_cut(bs, 12) == (1, 1, 12)
    assert rt.apply_stop_cut(bs, 6) is None        # frame 1 crosses 6
    assert rt.apply_stop_cut(bs, 16) is None
    assert rt.apply_stop_cut(bs, 0) == (0, 0, 0)


def test_corruption_raises(corpus):
    """A flipped residual bit decodes but fails the stream MD5, with the
    port's own InvalidChecksum."""
    bad = bytearray(corpus["lpc order 8"][0])
    bad[-200] ^= 0x10
    dd = zflac_tpu_torch.decode_to_device(bytes(bad), device="cpu")
    assert dd is not None
    with pytest.raises(InvalidChecksum):
        dd.to_host()


@pytest.mark.parametrize("name", ["constant heavy", "verbatim noise",
                                  "fixed order 3", "lpc order 32",
                                  "escaped partitions", "bps 8", "bps 24",
                                  "channels 1", "channels 5",
                                  "surround 8ch 24bit"])
def test_stages_match_jax(name, corpus):
    """The port's stages equal the JAX core truncated at the same
    point: residual_rows == stage "rows", sorted_stack == stage
    "transpose", reconstruct_pack2 == the chunk PCM (the packtail
    kernel's path, the 32-bit container's lpc2w and the general tail
    for 1, 5 and 8 channels)."""
    from zflac_tpu import format as fmt
    from zflac_tpu.runtime.device import _reconstruct_pack2_core

    ck = _first_chunk(corpus[name][0], max_frames=64, force_fp=64)
    cb = fmt.container_bits(ck.bits_per_sample)
    stages = ("rows", "transpose", "full")
    # One compile for the three truncations (XLA shares their prefix).
    want = jax.jit(lambda b: tuple(_reconstruct_pack2_core(
        b, spec=ck.spec_key(), num_channels=ck.C, container_bits=cb,
        do_decorrelate=ck.do_decorrelate, use_pallas=False, stage=stage)
        for stage in stages))(jnp.asarray(ck.device_buf))
    want = dict(zip(stages, map(np.asarray, want)))

    buf, geom = rt.chunk_to_torch(ck, "cpu")
    assert rt.lpc_kernel(geom, cb) == ("lpc2w" if cb == 32 else "lpc2")
    rows_t = rt.residual_rows(buf, geom)
    np.testing.assert_array_equal(rows_t.numpy(), want["rows"])
    stack = rt.sorted_stack(rows_t, buf, geom, container_bits=cb)
    np.testing.assert_array_equal(stack.numpy(), want["transpose"])
    pcm = rt.reconstruct_pack2(buf, geom, container_bits=cb)
    assert pcm.dtype == getattr(torch, want["full"].dtype.name)
    np.testing.assert_array_equal(pcm.numpy(), want["full"])


@pytest.mark.parametrize("name", ["bps 32", "hi-res 32bit",
                                  "hi-res 32bit mid_side",
                                  "hi-res 32bit left_side"])
def test_wide_chunk_matches_jax(name, corpus):
    """A wide chunk (33-bit side channels) reconstructs in int64 through
    lpc2w33 to the JAX wide path's [Fp, Bp, 2] int32 PCM."""
    from zflac_tpu.runtime.device import _reconstruct_pack2_core

    ck = _first_chunk(corpus[name][0], max_frames=64, force_fp=64)
    assert "warm_hi" in ck.off and ck.C == 2
    want = np.asarray(jax.jit(lambda b: _reconstruct_pack2_core(
        b, spec=ck.spec_key(), num_channels=2, container_bits=32,
        do_decorrelate=ck.do_decorrelate, use_pallas=False))(
        jnp.asarray(ck.device_buf)))

    buf, geom = rt.chunk_to_torch(ck, "cpu")
    assert geom.wide and rt.lpc_kernel(geom, 32) == "lpc2w33"
    rows_t = rt.residual_rows(buf, geom)
    stack = rt.sorted_stack(rows_t, buf, geom, container_bits=32)
    assert rows_t.dtype == stack.dtype == torch.int64
    pcm = rt.reconstruct_pack2(buf, geom, container_bits=32)
    assert pcm.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(pcm.numpy(), want)


@pytest.mark.parametrize("name", ["bps 24", "bps 20"])
def test_md5_3byte_domain_matches_jax(name, corpus):
    """The port's verify_stream_md5 agrees with the JAX package's on
    the 3-byte sample domain: both accept the stream's PCM and both
    reject it with one sample changed."""
    from zflac_tpu import format as fmt
    from zflac_tpu.runtime.decode import verify_stream_md5

    data, pcm, _sr, bps = corpus[name]
    assert fmt.md5_bytes_per_sample(bps) == 3
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu")
    pcm_md5 = pcm.astype(np.int32).reshape(-1)
    bad = pcm_md5.copy()
    bad[len(bad) // 2] ^= 1 << 16
    for arr, ok in ((pcm_md5, True), (bad, False)):
        assert rt.verify_stream_md5(arr, bps, dd.md5) is ok
        assert verify_stream_md5(arr, bps, dd.md5) is ok


def test_chunk_to_torch_round_trip(corpus):
    ck = _first_chunk(corpus["stereo mid_side"][0])
    buf, geom = rt.chunk_to_torch(ck, "cpu")
    assert buf.dtype == torch.int32 and buf.device.type == "cpu"
    np.testing.assert_array_equal(buf.numpy(), ck.device_buf)
    spec = ck.spec_key()
    assert (geom.Fp, geom.Sp, geom.Bp, geom.GPB, geom.W, geom.NGp,
            geom.n_patch_p, geom.C, geom.classes) == spec[:9]
    assert geom.off == dict(spec[9]) and geom.Ssort == ck.Ssort
    off = ck.off["inv"]
    np.testing.assert_array_equal(geom.sect(buf, "inv", geom.Sp).numpy(),
                                  ck.buf[off:off + ck.Sp])
    ck.buf[:] = 0                       # the upload is a copy
    assert buf.abs().sum() > 0


def test_port_imports_no_jax():
    """In a fresh interpreter the port and chip_smoke.py load without
    JAX (the card's machine has none) and without any module of the
    JAX package: the port keeps its own copies."""
    code = ("import sys\n"
            "import zflac_tpu_torch\n"
            "from zflac_tpu_torch.runtime import device, reconstruct, "
            "wide, decode, seek, pack, scatter\n"
            "from zflac_tpu_torch.ops import rice16, lpc2, lpc2w, packtail, "
            "lpc\n"
            "from zflac_tpu_torch import _kernels, format, bitio, errors, "
            "crc, result, plan, metadata, oracle, encoder, testing\n"
            "from zflac_tpu_torch.index import native_indexer, py_indexer\n"
            "from zflac_tpu_torch.utils import log, timer, profiler\n"
            "from zflac_tpu_torch.parallel import shard, longstream, "
            "distributed\n"
            "from zflac_tpu_torch import cli\n"
            "from zflac_tpu_torch.tools import kernel_sass\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'zflac_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_route_launches_nothing(corpus):
    _kernels.launches.clear()
    zflac_tpu_torch.decode_to_device(corpus["constant heavy"][0],
                                     device="cpu")
    assert sum(_kernels.launches.values()) == 0


def test_kernel_wrappers_refuse_other_devices():
    """The wrappers run the plain version only for CPU tensors: tensors
    elsewhere, or on several devices, raise instead of falling back."""
    from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct
    from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct,
                                           lpc2w_reconstruct)
    from zflac_tpu_torch.ops.packtail import packtail
    from zflac_tpu_torch.ops.lpc import lpc_reconstruct
    from zflac_tpu_torch.ops.rice16 import rice16_unpack, rice16_unpack_rows

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with pytest.raises(ValueError, match="device"):
        rice16_unpack_rows(meta(8, 1024), meta(1024), Ssort=1024)
    with pytest.raises(ValueError, match="several devices"):
        rice16_unpack_rows(torch.zeros((8, 1024), dtype=torch.int32),
                           meta(1024), Ssort=1024)
    for lpc in (lpc2_reconstruct, lpc2w_reconstruct, lpc2w33_reconstruct):
        with pytest.raises(ValueError, match="device"):
            lpc(meta(128, 128), meta(8, 128), meta(128), meta(128))
    with pytest.raises(ValueError, match="several devices"):
        lpc2w33_reconstruct(torch.zeros((128, 128), dtype=torch.int64),
                            meta(8, 128), meta(128), meta(128))
    with pytest.raises(ValueError, match="device"):
        packtail(meta(129, 128), meta(8), meta(8), meta(4), Fp=4,
                 container_bits=16)
    with pytest.raises(ValueError, match="device"):
        rice16_unpack(meta(8, 1024), meta(1024))
    with pytest.raises(ValueError, match="several devices"):
        rice16_unpack(torch.zeros((8, 1024), dtype=torch.int32), meta(1024))
    for dtype in (torch.int32, torch.int64):                # lpc, lpc64
        rows = torch.empty((128, 128), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="device"):
            lpc_reconstruct(rows, meta(32, 128), meta(128), meta(128))
        with pytest.raises(ValueError, match="several devices"):
            lpc_reconstruct(torch.zeros((128, 128), dtype=dtype),
                            meta(32, 128), meta(128), meta(128))


def test_cuda_request_without_a_card_raises(corpus):
    """device="cuda" with no usable card raises: nothing moves to the
    CPU on its own, and the kernels cannot be built without nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = corpus["lpc order 8"][0]
    with pytest.raises(RuntimeError, match="CUDA"):
        zflac_tpu_torch.decode_to_device(data, device="cuda")
    for call in (
            lambda: zflac_tpu_torch.decode(data, engine="torch",
                                           device="cuda"),
            lambda: zflac_tpu_torch.decode_pipelined(data, device="cuda"),
            lambda: list(zflac_tpu_torch.stream_decode(data,
                                                       device="cuda")),
            lambda: zflac_tpu_torch.decode_range(data, 0, 10,
                                                 device="cuda"),
            lambda: zflac_tpu_torch.decode_tolerant(data, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    try:
        _kernels.find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _kernels.library()


def test_engine_guards(corpus):
    """An unknown engine raises ValueError (no silent default path;
    the JAX package's "auto" is not an engine of the port); decode's
    default engine is the torch engine, and it and each rows-engine
    entry point runs on the card when no device is given, so here, with
    no card, it raises the no-card RuntimeError and never runs on the
    CPU by itself; only engine="native" runs the host engine."""
    data = corpus["lpc order 8"][0]
    for engine in ("tpu", "cuda", "auto"):
        with pytest.raises(ValueError, match="unknown engine"):
            zflac_tpu_torch.decode(data, engine=engine, device="cpu")
    for call in (
            lambda: zflac_tpu_torch.decode(data),
            lambda: zflac_tpu_torch.decode(data, engine="torch"),
            lambda: zflac_tpu_torch.decode(data, safe_lpc=True),
            lambda: zflac_tpu_torch.decode_pipelined(data),
            lambda: list(zflac_tpu_torch.stream_decode(data)),
            lambda: zflac_tpu_torch.decode_range(data, 0, 10),
            lambda: zflac_tpu_torch.decode_tolerant(data)):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    assert zflac_tpu_torch.decode(
        data, device="cpu").stats["engine"] == "torch"
    r = zflac_tpu_torch.decode(data, engine="native")
    assert r.stats["engine"] == "native"
    np.testing.assert_array_equal(
        r.interleaved,
        zflac_tpu_torch.decode(data, engine="torch",
                               device="cpu").interleaved)


def test_entry_points_default_to_the_card(corpus):
    """Every public entry point takes device="cuda" when none is given,
    and decode the torch engine; decode_to_device and decode called
    with neither raise here, with no card, instead of running on the
    CPU."""
    import inspect

    from zflac_tpu_torch.index import build_plan
    from zflac_tpu_torch.parallel import distributed, longstream, shard
    from zflac_tpu_torch.runtime import decode as rd
    from zflac_tpu_torch.runtime import seek as rs

    for fn in (rt.decode_to_device, rd.decode, rd.decode_pipelined,
               rd.stream_decode, rs.decode_range, rs.decode_tolerant,
               distributed.decode_longstream_distributed):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__name__
    assert inspect.signature(rd.decode).parameters["engine"].default == \
        "torch"
    # The multi-device entry points take their devices as a list: the
    # default is every visible card, and a CUDA entry with no card
    # raises.
    assert inspect.signature(shard.make_mesh).parameters[
        "devices"].default is None
    assert inspect.signature(distributed.decode_pack2_distributed) \
        .parameters["devices"].default is None
    data = corpus["lpc order 8"][0]
    if not torch.cuda.is_available():
        for call in (
                lambda: zflac_tpu_torch.decode_to_device(data),
                lambda: zflac_tpu_torch.decode(data),
                lambda: shard.make_mesh(),
                lambda: shard.decode_to_device_sharded(data, ["cuda:0"] * 2),
                lambda: shard.reconstruct_sharded(build_plan(data),
                                                  ["cuda:0"]),
                lambda: longstream.decode_longstream(data, 2, ["cuda:0"]),
                lambda: distributed.decode_longstream_distributed(data),
                lambda: distributed.decode_pack2_distributed(data),
                lambda: distributed.decode_pack2_distributed(
                    data, devices=["cuda:0"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_entry_points_take_a_path(corpus, tmp_path):
    """Like zflac_tpu's front door, the entry points take a file path as
    well as bytes."""
    data = corpus["lpc order 8"][0]
    path = tmp_path / "s.flac"
    path.write_bytes(data)
    a = zflac_tpu_torch.decode(str(path), engine="torch", device="cpu")
    b = zflac_tpu_torch.decode(data, engine="torch", device="cpu")
    np.testing.assert_array_equal(a.interleaved, b.interleaved)
    r = zflac_tpu_torch.decode_range(path, 100, 50, device="cpu")
    np.testing.assert_array_equal(r.interleaved,
                                  b.interleaved[200:300])


# ---- empty shapes: the wrappers return what the plain versions do ----

def test_empty_shapes_return_empty():
    """B == 0 and n == 0 through the LPC wrappers, NGp == 0 through
    rice16 and Fp == 0 through packtail: the plain versions' empty
    results, which the CUDA route returns too without a launch (its
    launchers reject an empty grid)."""
    from zflac_tpu_torch.ops.lpc import (lpc_reconstruct,
                                         lpc_reconstruct_ref)
    from zflac_tpu_torch.ops.lpc2 import (launch_recurrence,
                                          lpc2_reconstruct,
                                          lpc2_reconstruct_ref)
    from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct,
                                           lpc2w33_reconstruct_ref,
                                           lpc2w_reconstruct,
                                           lpc2w_reconstruct_ref)
    from zflac_tpu_torch.ops.packtail import packtail, packtail_ref
    from zflac_tpu_torch.ops.rice16 import (G2, rice16_unpack,
                                            rice16_unpack_ref,
                                            rice16_unpack_rows,
                                            rice16_unpack_rows_ref)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype)

    for B, n in ((0, 128), (128, 0), (0, 0)):
        for fn, ref, dtype in (
                (lpc2_reconstruct, lpc2_reconstruct_ref, torch.int32),
                (lpc2w_reconstruct, lpc2w_reconstruct_ref, torch.int32),
                (lpc2w33_reconstruct, lpc2w33_reconstruct_ref, torch.int64)):
            args = (z(B, n, dtype=dtype), z(8, n), z(n), z(n))
            got, want = fn(*args), ref(*args)
            assert got.shape == want.shape == (B, n)
            assert got.dtype == want.dtype == dtype
        for dtype in (torch.int32, torch.int64):
            args = (z(B, n, dtype=dtype), z(32, n), z(n), z(n))
            got, want = lpc_reconstruct(*args), lpc_reconstruct_ref(*args)
            assert got.shape == want.shape == (B, n) and got.dtype == dtype
    for W in (8, 16):
        got = rice16_unpack_rows(z(W, 0), z(0), Ssort=64)
        want = rice16_unpack_rows_ref(z(W, 0), z(0), Ssort=64)
        assert got.shape == want.shape == (0, 64)
        assert got.dtype == want.dtype == torch.int32
        got, want = rice16_unpack(z(W, 0), z(0)), rice16_unpack_ref(
            z(W, 0), z(0))
        assert got.shape == want.shape == (G2, 0)
    for cb, dtype in ((16, torch.int32), (8, torch.int16)):
        args = (z(3, 128), z(0), z(0), z(0))
        got = packtail(*args, Fp=0, container_bits=cb)
        want = packtail_ref(*args, Fp=0, container_bits=cb)
        assert got.shape == want.shape == (0, 128)
        assert got.dtype == want.dtype == dtype

    # The CUDA route's argument checks, then its early return: with the
    # launch stubbed out, an empty shape must not reach it.
    def no_launch(*a, **k):
        raise AssertionError("an empty shape reached the launcher")

    real = _kernels.launch
    _kernels.launch = no_launch
    try:
        for B, n in ((0, 128), (128, 0)):
            out = launch_recurrence("lpc2", torch.int32, z(B, n), z(8, n),
                                    z(n), z(n))
            assert out.shape == (B, n)
        from zflac_tpu_torch.ops import rice16
        assert rice16._launch("rice16", z(8, 0), z(0), 64).shape == (0, 64)
        # The flat layout of no group: Ssort = NG = 0, one empty p-row.
        assert rice16._launch("rice16_flat", z(8, 0), z(0),
                              0).shape == (G2, 0)
        with pytest.raises(ValueError, match="not a multiple"):
            rice16._launch("rice16", z(8, 64), z(64), 0)
    finally:
        _kernels.launch = real


# ---- a launch leaves the thread's CUDA device as it found it ----

def test_launch_runs_inside_a_device_guard(monkeypatch):
    """_kernels.launch calls the C launcher (which switches the CUDA
    device and does not switch back) inside torch.cuda.device(device)
    for the tensors' device, on that device's current stream, and
    counts the launch after the guard is left."""
    import contextlib

    events = []
    dev = torch.device("cuda", 1)

    class Lib:
        @staticmethod
        def zft_lpc2(*args):
            events.append(("launcher", args))
            return 0

        @staticmethod
        def zft_packtail(*args):
            events.append(("launcher", args))
            return 7

        @staticmethod
        def zft_error_string(rc):
            return b"stub error"

    @contextlib.contextmanager
    def guard(device):
        events.append(("enter", device))
        try:
            yield
        finally:
            events.append(("exit", device))

    class Stream:
        cuda_stream = 1234

    def current_stream(device):
        events.append(("stream", device))
        return Stream()

    monkeypatch.setattr(_kernels, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    _kernels.launches.clear()
    _kernels.launch("lpc2", dev, 11, 22)
    assert events == [("enter", dev), ("stream", dev),
                      ("launcher", (11, 22, 1, 1234)), ("exit", dev)]
    assert _kernels.launches == {"lpc2": 1}
    # A launcher that fails raises after the guard is left, uncounted.
    events.clear()
    with pytest.raises(RuntimeError, match="CUDA error 7 .stub error."):
        _kernels.launch("packtail", dev, 5)
    assert [e[0] for e in events] == ["enter", "stream", "launcher", "exit"]
    assert _kernels.launches == {"lpc2": 1}
    _kernels.launches.clear()


def test_launch_counts_under_the_lock(monkeypatch):
    """Launches from several threads (shards driven in parallel) are
    all counted."""
    import contextlib
    import threading

    class Lib:
        @staticmethod
        def zft_lpc(*args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_kernels, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    _kernels.launches.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _kernels.launch("lpc", torch.device("cuda", 0))
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _kernels.launches == {"lpc": 16000}
    _kernels.launches.clear()


def test_reconstruct_chunks_deals_chunks_round_robin(monkeypatch, corpus):
    """The loop decode_to_device and decode_to_device_sharded share:
    chunk i goes to devices[i % D], `each` sees every uploaded buffer,
    and the PCM is decode_to_device's."""
    from zflac_tpu_torch.bitio import BitReader
    from zflac_tpu_torch.oracle import parse_metadata

    data = corpus["lpc order 8"][0]
    br = BitReader(data)
    info = parse_metadata(br)
    cks = rt.stream_chunks(data, info, br.pos // 8, chunk_frames=2)
    assert len(cks) >= 3
    went_to = []
    real = rt.chunk_to_torch

    def record(ck, device):
        went_to.append(device)
        return real(ck, "cpu")

    monkeypatch.setattr(rt, "chunk_to_torch", record)
    seen = []
    pcms = rt.reconstruct_chunks(cks, ["a", "b"],
                                 each=lambda buf, geom: seen.append(geom.Fp))
    assert went_to == ["a", "b"] * (len(cks) // 2) + ["a"] * (len(cks) % 2)
    assert seen == [2] * len(cks)
    monkeypatch.undo()
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu", chunk_frames=2)
    assert len(dd.chunks) == len(pcms)
    for got, want in zip(pcms, dd.chunks):
        assert torch.equal(got, want)


@pytest.mark.parametrize("total, want", [
    (0, None),              # no total
    (700, None),            # the total is the decoded length
    (650, None),            # a frame crosses the total: all is kept
    (400, (1, 400)),        # chunk 1's second frame starts at the total
    (300, (1, 300)),        # chunk 1 keeps no frame
    (100, (0, 100)),
])
def test_cut_at_total_edits_the_tables(total, want):
    """cut_at_total zeroes the tables from the first dropped frame on,
    and leaves them alone when nothing drops."""
    num_frames = [3, 2, 2]
    block_sizes = [np.array([100, 100, 100]), np.array([100, 100]),
                   np.array([100, 100])]
    before = [b.copy() for b in block_sizes]
    assert rt.cut_at_total(num_frames, block_sizes, total) == want
    if want is None:
        assert num_frames == [3, 2, 2]
        for b, b0 in zip(block_sizes, before):
            np.testing.assert_array_equal(b, b0)
        return
    ci, kept = want
    assert sum(num_frames) * 100 == kept
    assert sum(int(b.sum()) for b in block_sizes) == kept
    assert all(f == 0 and len(b) == 0 for f, b in
               zip(num_frames[ci + 1:], block_sizes[ci + 1:]))
    for b0 in before:       # the chunks' own arrays are not written to
        assert (b0 == 100).all()


# ---- the profiler hook and the stage timers ----

def test_maybe_trace_is_a_noop_when_unset(monkeypatch, tmp_path):
    from zflac_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "_PROFILE_DIR", "")
    monkeypatch.chdir(tmp_path)
    with profiler.maybe_trace("nothing"):
        pass
    assert os.listdir(tmp_path) == []


def test_maybe_trace_writes_a_trace_per_decode(monkeypatch, tmp_path,
                                               corpus):
    """With the profile directory set, each decode() leaves one Chrome
    trace file there that holds the region's label; the PCM is what it
    is without tracing."""
    import json

    from zflac_tpu_torch.utils import profiler

    data = corpus["lpc order 8"][0]
    want = zflac_tpu_torch.decode(data, device="cpu").interleaved
    out = tmp_path / "traces"
    monkeypatch.setattr(profiler, "_PROFILE_DIR", str(out))
    for n in (1, 2):
        got = zflac_tpu_torch.decode(data, device="cpu").interleaved
        np.testing.assert_array_equal(got, want)
        assert len(os.listdir(out)) == n
    for name in os.listdir(out):
        assert name.startswith("zflac_tpu_torch.decode.")
        with open(out / name) as f:
            trace = json.load(f)
        assert any(e.get("name") == "zflac_tpu_torch.decode"
                   for e in trace["traceEvents"])


def test_stage_timers_sum_repeated_stages():
    import time

    from zflac_tpu_torch.utils import StageTimers, get_logger

    t = StageTimers()
    for _ in range(3):
        with t.stage("scan"):
            time.sleep(0.002)
    with pytest.raises(KeyError):
        with t.stage("fails"):
            raise KeyError("still timed")
    times = t.as_dict()
    assert set(times) == {"scan", "fails"} and times["scan"] >= 0.006
    times["scan"] = 0                      # a copy
    assert t.times["scan"] >= 0.006
    assert repr(t).startswith("StageTimers(scan=")
    assert get_logger("shard").name.endswith("shard")


def test_kernel_sass_counts_store_runs():
    """tools/kernel_sass.py on a cuobjdump-style listing: the body of
    the longest loop without its inner loop, cut after each branch into
    runs, each run's outputs counted from its stores' widths (a 16-byte
    store of int16 samples holds 8), NOPs and the trailing self-branch
    left out."""
    from zflac_tpu_torch.tools.kernel_sass import long_loops, store_runs
    listing = "\n".join(
        f"        /*{a:04x}*/  {ins} ;" for a, ins in enumerate([
            "MOV R1, c[0x0][0x28]",
            "LDG.E.128 R4, [R2.64]",            # outer loop starts here
            "IADD3 R0, R0, 0x1, RZ",            # inner loop
            "@P0 BRA 0x2",
            "STG.E.EF.128 [R2.64], R4",
            "@P1 BRA 0x7",
            "STG.E.U16 [R2.64], R0",
            "ISETP.GE.AND P0, PT, R0, 0x10, PT",
            "@!P0 BRA 0x1",
            "EXIT",
            "BRA 0xa",
            "NOP",
        ]))
    # Addresses step by 1 here, so a branch's target is an index.
    total, body, runs = store_runs(listing, 2)
    assert (total, body) == (11, 6)
    assert runs == [(3, 8), (3, 1)]
    assert [n for n, _ in long_loops(listing, least=2)] == [8]
