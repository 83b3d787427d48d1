"""The JAX suite's independent bitstreams through every entry point of
the PyTorch port (zflac_tpu_torch) on the CPU, against each vector's
expected PCM and the JAX package's same entry point, with zero
tolerance and equal dtypes.

The 29 streams come from the port's own copy,
zflac_tpu_torch/tools/vectors.py: the 20 hand-built vectors of
tests/test_handvectors.py (bits from the RFC text, not from the
encoder), the three RFC 9639 example streams of tests/test_golden.py
(libflac bits) and the six edge-of-envelope streams of
tests/test_edge_cases.py, plus its declared-total cut. The copy is
first held equal to those files. Then each stream goes through
decode (engine "torch", also with safe_lpc and check_crc; engine
"native"), decode_oracle, decode_to_device (to_host and
interleaved_device; None exactly where the JAX package's is None),
decode_tolerant, decode_pipelined, stream_decode and decode_range at
four starts. Last, the front door takes a path, a bytearray and a
memoryview wherever it takes bytes."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from conftest import expected_output  # noqa: E402
from zflac_tpu import errors as jerr  # noqa: E402
from zflac_tpu.encoder import EncoderConfig as JEncoderConfig  # noqa: E402
from zflac_tpu.encoder import encode as jencode  # noqa: E402
from zflac_tpu.index import build_plan  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.testing import tone_mix as jtone_mix  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import errors as perr  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.tools import vectors  # noqa: E402

from torch_slice import assert_same  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

NAMES = ([v.__name__ for v in vectors.VECTORS] + list(vectors.EXAMPLES)
         + list(vectors.EDGE_CASES))
# Frames a chunk for decode_pipelined and stream_decode: the streams of
# more than four frames decode in several chunks.
CHUNK_FRAMES = 4


@functools.lru_cache(maxsize=None)
def _all():
    return {v.name: v for v in vectors.all_vectors()}


def _same_pcm(got, want, what=""):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_result(got, want, expected):
    """A port DecodedFLAC equal to the JAX one and to the expected
    PCM, format facts included."""
    _same_pcm(got.interleaved, expected, "expected")
    _same_pcm(got.interleaved, want.interleaved, "JAX package")
    assert (got.channels, got.sample_rate, got.bits_per_sample) == (
        want.channels, want.sample_rate, want.bits_per_sample)


# ---- the copy equals the original ----------------------------------

# The JAX suite's edge-case streams, built as tests/test_edge_cases.py
# builds them, with the JAX package's encoder.
JAX_EDGE = {
    "single_sample_stream": lambda: (
        np.array([[1234, -4321]], dtype=np.int64), 44100, 16,
        JEncoderConfig(block_size=4096)),
    "final_block_size_one": lambda: (
        jtone_mix(4097, 1, 16, seed=1), 44100, 16,
        JEncoderConfig(block_size=4096)),
    "empty_stream": lambda: (
        np.zeros((0, 2), dtype=np.int64), 44100, 16, JEncoderConfig()),
    "unknown_total_with_tiny_frames": lambda: (
        jtone_mix(100, 2, 16, seed=2), 44100, 16,
        JEncoderConfig(block_size=16, omit_total_samples=True)),
    "wrong_total_grows": lambda: (
        jtone_mix(3000, 2, 16, seed=3), 44100, 16,
        JEncoderConfig(block_size=512, total_samples_fudge=-1500)),
    "8bit_minimum_depth": lambda: (
        jtone_mix(500, 1, 8, seed=4), 8000, 8,
        JEncoderConfig(block_size=256)),
}
# test_golden.py states Example 1's samples inside its test.
EXAMPLE_1_SAMPLES = np.array([25588, 10416], dtype=np.int16)


def _original(name):
    """(bytes, expected PCM) of stream `name` as the JAX suite makes
    it."""
    import test_golden
    import test_handvectors
    if name.startswith("v_"):
        _, data, expected = getattr(test_handvectors, name)()
        return data, expected
    if name in vectors.EXAMPLES:
        samples = (EXAMPLE_1_SAMPLES if name == "EXAMPLE_1"
                   else getattr(test_golden, f"{name}_SAMPLES"))
        return getattr(test_golden, name), samples
    pcm, rate, bps, cfg = JAX_EDGE[name]()
    return jencode(pcm, rate, bps, cfg), expected_output(pcm, bps)


def test_names_cover_the_jax_suites():
    """Every vector of test_handvectors.py and every stream-making case
    of test_edge_cases.py is here, once."""
    import test_edge_cases
    import test_handvectors
    assert [v.__name__ for v in test_handvectors.VECTORS] == \
        [v.__name__ for v in vectors.VECTORS]
    edge = {n[len("test_"):] for n, f in vars(test_edge_cases).items()
            if n.startswith("test_") and "decode" in f.__code__.co_varnames}
    assert edge == set(vectors.EDGE_CASES)
    assert len(NAMES) == len(set(NAMES)) == 29
    assert list(_all()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_copy_equals_original(name):
    v = _all()[name]
    data, expected = _original(name)
    assert v.data == data
    _same_pcm(v.expected, expected)


def test_cut_copy_equals_original():
    """The declared-total stream: test_edge_cases.py's bytes, and the
    declared samples of its input."""
    v, declared = vectors.declared_total_cut()
    pcm = jtone_mix(3072, 2, 16, seed=9)
    assert declared == 1024
    assert v.data == jencode(pcm, 44100, 16, JEncoderConfig(
        block_size=512, total_samples_fudge=declared - 3072))
    _same_pcm(v.expected, expected_output(pcm[:declared], 16))


@pytest.mark.parametrize("name", list(vectors.EXAMPLES))
def test_example_facts(name):
    """The format facts test_golden.py asserts, in both packages."""
    data, _, facts = vectors.EXAMPLES[name]
    for r in (zflac_tpu_torch.decode(data, device="cpu"),
              zflac_tpu.decode(data)):
        assert (r.channels, r.bits_per_sample, r.sample_rate,
                r.interleaved.dtype) == tuple(facts)


# ---- every entry point, stream by stream ---------------------------

DECODE_VARIANTS = {"default": {}, "safe_lpc": {"safe_lpc": True},
                   "check_crc": {"check_crc": True}}


@pytest.mark.parametrize("variant", list(DECODE_VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_decode_torch(name, variant):
    """The rows engine (safe_lpc: every LPC subframe through the plain
    lpc64 route) against zflac_tpu.decode(engine="tpu")."""
    v = _all()[name]
    kw = dict(v.kwargs, **DECODE_VARIANTS[variant])
    got = zflac_tpu_torch.decode(v.data, engine="torch", device="cpu", **kw)
    assert got.stats["engine"] == "torch"
    _same_result(got, zflac_tpu.decode(v.data, engine="tpu", **kw),
                 v.expected)


@pytest.mark.parametrize("name", NAMES)
def test_decode_native(name):
    v = _all()[name]
    _same_result(zflac_tpu_torch.decode(v.data, engine="native",
                                        device="cpu", **v.kwargs),
                 zflac_tpu.decode(v.data, engine="native", **v.kwargs),
                 v.expected)


@pytest.mark.parametrize("name", NAMES)
def test_decode_oracle(name):
    v = _all()[name]
    _same_result(zflac_tpu_torch.decode_oracle(v.data, **v.kwargs),
                 zflac_tpu.decode_oracle(v.data, **v.kwargs), v.expected)


@pytest.mark.parametrize("name", NAMES)
def test_decode_to_device(name):
    """The pack2 path: None exactly where the JAX package's is None
    (the empty stream alone); else the same frames, block sizes and PCM
    (host with MD5 verified, and the device assembly in both
    normalization domains) as the JAX DeviceDecoded, and the expected
    PCM."""
    v = _all()[name]
    dd = zflac_tpu_torch.decode_to_device(v.data, device="cpu")
    ref = zflac_tpu.decode_to_device(v.data)
    assert (dd is None) == (ref is None) == (name == "empty_stream")
    if dd is None:
        return
    _same_pcm(assert_same(dd, ref).interleaved, v.expected, "to_host")
    _same_pcm(dd.interleaved_device().numpy().reshape(-1), v.expected,
              "interleaved_device")


def _concat(chunks, like):
    return np.concatenate(chunks) if chunks else like[:0]


ROWS_ENTRIES = {
    "decode_tolerant": lambda pkg, data, kw: pkg.decode_tolerant(data, **kw),
    "decode_pipelined": lambda pkg, data, kw: pkg.decode_pipelined(
        data, chunk_frames=CHUNK_FRAMES, **kw),
    "stream_decode": lambda pkg, data, kw: list(pkg.stream_decode(
        data, chunk_frames=CHUNK_FRAMES, **kw)),
}


# Where the JAX package's entry point cannot serve as the reference:
# its decode_tolerant places samples at their coded positions counted
# from sample 0, and v_varblock_36bit numbers its first frame at 2^35,
# so it allocates 64 GiB of leading silence (MemoryError, or minutes of
# hashing where the host overcommits). The port counts from the first
# frame (runtime/seek.py) and is held to the expected PCM alone.
JAX_DEFECTS = {("v_varblock_36bit", "decode_tolerant")}


@pytest.mark.parametrize("entry", list(ROWS_ENTRIES))
@pytest.mark.parametrize("name", NAMES)
def test_rows_entry_point(name, entry):
    """decode_tolerant (the same stats too: no resync, MD5 good),
    decode_pipelined and stream_decode (its chunks, and their
    concatenation) in chunks of CHUNK_FRAMES frames."""
    v = _all()[name]
    call = ROWS_ENTRIES[entry]
    if name == "empty_stream" and entry == "decode_tolerant":
        # No frame to resynchronize on: both packages raise.
        with pytest.raises(perr.FlacError, match="no decodable frames"):
            call(zflac_tpu_torch, v.data, {"device": "cpu"})
        with pytest.raises(jerr.FlacError, match="no decodable frames"):
            call(zflac_tpu, v.data, {})
        return
    got = call(zflac_tpu_torch, v.data, {"device": "cpu"})
    if (name, entry) in JAX_DEFECTS:
        _same_pcm(got.interleaved, v.expected)
        assert got.stats == {"engine": "tolerant", "resyncs": 0,
                             "segments": 1, "md5_ok": True,
                             "frames": 3}
        return
    want = call(zflac_tpu, v.data, {})
    if entry == "stream_decode":
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_pcm(g, w, "chunk")
        _same_pcm(_concat(got, v.expected), v.expected)
        return
    _same_result(got, want, v.expected)
    if entry == "decode_tolerant":
        assert got.stats == want.stats
        assert got.stats["resyncs"] == 0 and got.stats["md5_ok"]


@pytest.mark.parametrize("declared", [4096, 2048])
def test_tolerant_sample_positions(declared):
    """decode_tolerant on a stream that lost its first two frames of
    1024 (the remaining frames are numbered 2 and 3). With the
    original's STREAMINFO total, 4096, they go to their coded positions
    after 2048 samples of silence, as in the JAX package. With a
    declared total of 2048 the first frame lies past it, so it is
    sample 0 in the port, where the JAX package still counts from 0."""
    from torch_slice import with_total
    pcm = jtone_mix(4096, 2, 16, seed=21)
    data = jencode(pcm, 44100, 16, JEncoderConfig(block_size=1024))
    offsets = build_plan(data).frame_byte_offset
    cut = with_total(data[:offsets[0]] + data[offsets[2]:], declared)
    got = zflac_tpu_torch.decode_tolerant(cut, device="cpu")
    want = zflac_tpu.decode_tolerant(cut)
    assert got.stats == want.stats
    assert got.stats["resyncs"] == 0 and not got.stats["md5_ok"]
    tail = expected_output(pcm[2048:], 16)
    if declared == 4096:
        _same_result(got, want, np.concatenate([np.zeros_like(tail), tail]))
    else:
        _same_pcm(got.interleaved, tail)
        assert len(want.interleaved) == 2 * len(tail)


@pytest.mark.parametrize("name", NAMES)
def test_decode_range(name):
    """decode_range at the first sample, the second, the middle and the
    last, for a quarter of the stream and for the whole length (clipped
    to the stream's end)."""
    v = _all()[name]
    C = parse_metadata(BitReader(v.data)).channel_count
    n = len(v.expected) // C
    starts = sorted({0, min(1, n - 1), n // 2, n - 1}) if n else [0]
    for start in starts:
        for count in (1 + n // 4, max(n, 1)):
            got = zflac_tpu_torch.decode_range(v.data, start, count,
                                               device="cpu")
            want = zflac_tpu.decode_range(v.data, start, count)
            end = min(start + count, n)
            _same_result(got, want, v.expected[start * C:end * C])


# ---- the declared-total cut ----------------------------------------


def test_declared_total_cut_raises_by_default():
    """The stream MD5 covers all the input: the default decode raises
    InvalidChecksum in both packages."""
    v, _ = vectors.declared_total_cut()
    with pytest.raises(perr.InvalidChecksum):
        zflac_tpu_torch.decode(v.data, device="cpu")
    with pytest.raises(jerr.InvalidChecksum):
        zflac_tpu.decode(v.data)


@pytest.mark.parametrize("route", ["torch", "native", "decode_to_device"])
def test_declared_total_cut(route):
    """With verify_md5=False both engines and decode_to_device (which
    must not decline) give exactly the declared samples, as the JAX
    package does."""
    v, declared = vectors.declared_total_cut()
    if route == "decode_to_device":
        dd = zflac_tpu_torch.decode_to_device(v.data, device="cpu")
        assert dd is not None, "pack2 declined an admissible stream"
        got = dd.to_host(verify_md5=False)
        want = zflac_tpu.decode_to_device(v.data).to_host(verify_md5=False)
    else:
        got = zflac_tpu_torch.decode(v.data, engine=route, device="cpu",
                                     **v.kwargs)
        want = zflac_tpu.decode(v.data, engine="tpu" if route == "torch"
                                else route, **v.kwargs)
    assert got.num_samples == declared
    _same_result(got, want, v.expected)


# ---- the front door takes what the JAX package's takes -------------

FRONT_DOOR = {
    "decode_to_device": lambda pkg, data, kw: pkg.decode_to_device(
        data, **kw).to_host().interleaved,
    "decode": lambda pkg, data, kw: pkg.decode(data, **kw).interleaved,
    "decode_range": lambda pkg, data, kw: pkg.decode_range(
        data, 3, 20, **kw).interleaved,
    "decode_tolerant": lambda pkg, data, kw: pkg.decode_tolerant(
        data, **kw).interleaved,
    "decode_pipelined": lambda pkg, data, kw: pkg.decode_pipelined(
        data, **kw).interleaved,
    "stream_decode": lambda pkg, data, kw: np.concatenate(
        list(pkg.stream_decode(data, **kw))),
    "decode_oracle": lambda pkg, data, kw: pkg.decode_oracle(
        data).interleaved,
}


@pytest.mark.parametrize("kind", ["path", "bytearray", "memoryview"])
@pytest.mark.parametrize("entry", list(FRONT_DOOR))
def test_front_door_input_kinds(entry, kind, tmp_path):
    """A path, a bytearray and a memoryview give the same PCM as bytes,
    and as the JAX package's same entry point on the same input
    (Example 2 of RFC 9639)."""
    data = vectors.EXAMPLE_2
    if kind == "path":
        arg = tmp_path / "example2.flac"
        arg.write_bytes(data)
        arg = str(arg)
    else:
        arg = bytearray(data) if kind == "bytearray" else \
            memoryview(bytearray(data))
    call = FRONT_DOOR[entry]
    kw = {} if entry == "decode_oracle" else {"device": "cpu"}
    got = call(zflac_tpu_torch, arg, kw)
    _same_pcm(got, call(zflac_tpu_torch, data, kw), "bytes")
    _same_pcm(got, call(zflac_tpu, arg, {}), "JAX package")
