"""The PyTorch port's other rows-engine entry points (zflac_tpu_torch)
against the JAX package's on the CPU, on the same inputs (the cases of
tests/test_pipelined.py and tests/test_seek_tolerant.py):
decode_pipelined (high-res and unknown totals too), stream_decode (raw
and normalized), decode_range (plain, through a SEEKTABLE, variable
blocking) and decode_tolerant (clean, one and two corrupt regions: the
same resyncs, segments, MD5 verdict and PCM). Tolerance zero."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from conftest import expected_output  # noqa: E402
from zflac_tpu.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu.index import build_plan_py  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.runtime import decode as jdec  # noqa: E402
from zflac_tpu.testing import correlated_stereo, tone_mix  # noqa: E402

import zflac_tpu_torch  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def _same(got, want):
    np.testing.assert_array_equal(got.interleaved, want.interleaved)
    assert (got.channels, got.sample_rate, got.bits_per_sample) == (
        want.channels, want.sample_rate, want.bits_per_sample)


@pytest.mark.parametrize("case", ["16bit", "highres", "unknown_total"])
def test_pipelined_matches_jax(case):
    """decode_pipelined: several chunks, the same PCM as the JAX
    function and the encoder's input, MD5 verified."""
    if case == "16bit":
        pcm, bps = correlated_stereo(64 * 1024, 16, seed=31), 16
        data = encode(pcm, 44100, 16, EncoderConfig(block_size=2048))
        chunk_frames = 8
    elif case == "highres":
        pcm, bps = tone_mix(16 * 1024, 2, 24, seed=32), 24
        data = encode(pcm, 96000, 24, EncoderConfig(block_size=1024))
        chunk_frames = 4
    else:
        pcm, bps = correlated_stereo(32 * 1024, 16, seed=34), 16
        data = encode(pcm, 44100, 16, EncoderConfig(
            block_size=1024, omit_total_samples=True))
        chunk_frames = 8
    got = zflac_tpu_torch.decode_pipelined(data, chunk_frames=chunk_frames,
                                           device="cpu")
    want = jdec.decode_pipelined(data, chunk_frames=chunk_frames)
    assert got.stats["chunks"] == want.stats["chunks"] > 1
    _same(got, want)
    np.testing.assert_array_equal(got.interleaved, expected_output(pcm, bps))


@pytest.mark.parametrize("bps,n,chunk_frames", [(16, 32 * 1024, 4),
                                                (12, 8 * 1024, 2)])
def test_stream_decode_matches_jax(bps, n, chunk_frames):
    """stream_decode yields the JAX generator's chunks, normalized (the
    12-bit stream carries the container shift)."""
    pcm = (correlated_stereo(n, bps, seed=33) if bps == 16
           else tone_mix(n, 2, bps, seed=34))
    bs = 2048 if bps == 16 else 1024
    data = encode(pcm, 44100, bps, EncoderConfig(block_size=bs))
    got = list(zflac_tpu_torch.stream_decode(
        data, chunk_frames=chunk_frames, device="cpu"))
    want = list(jdec.stream_decode(data, chunk_frames=chunk_frames))
    assert len(got) == len(want) >= (2 if bps == 16 else 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got),
                                  expected_output(pcm, bps))


def _stream(n=16 * 1024, bs=1024, **kw):
    pcm = correlated_stereo(n, 16, seed=21)
    return encode(pcm, 44100, 16, EncoderConfig(block_size=bs, **kw)), pcm


@pytest.mark.parametrize("start,count", [
    (0, 100), (1000, 4096), (5000, 1), (16 * 1024 - 10, 100),
    (3000, 10000), (20000, 5),
])
def test_decode_range_matches_jax(start, count):
    data, pcm = _stream()
    got = zflac_tpu_torch.decode_range(data, start, count, device="cpu")
    want = zflac_tpu.decode_range(data, start, count)
    assert got.stats == want.stats
    _same(got, want)
    np.testing.assert_array_equal(
        got.interleaved, expected_output(pcm[start:start + count], 16))


@pytest.mark.parametrize("start,count", [(100000, 4000),
                                         (16384 - 100, 300)])
def test_decode_range_via_seektable_matches_jax(start, count):
    """Indexing from the nearest SEEKTABLE point, inside one seek span
    and straddling a seek point."""
    pcm = correlated_stereo(128 * 1024, 16, seed=23)
    data = encode(pcm, 44100, 16,
                  EncoderConfig(block_size=4096, seektable_every=16384))
    got = zflac_tpu_torch.decode_range(data, start, count, device="cpu")
    want = zflac_tpu.decode_range(data, start, count)
    assert got.stats["engine"] == "seektable"
    assert got.stats == want.stats
    _same(got, want)
    np.testing.assert_array_equal(
        got.interleaved, expected_output(pcm[start:start + count], 16))


def test_decode_range_variable_blocking_matches_jax():
    pcm = tone_mix(8000, 2, 16, seed=22)
    data = encode(pcm, 44100, 16,
                  EncoderConfig(block_size=1024, variable_blocking=True))
    got = zflac_tpu_torch.decode_range(data, 2500, 3000, device="cpu")
    want = zflac_tpu.decode_range(data, 2500, 3000)
    _same(got, want)
    np.testing.assert_array_equal(
        got.interleaved, expected_output(pcm[2500:5500], 16))


def _corrupt(data, frames, at, n, xor):
    plan = build_plan_py(data)
    bad = bytearray(data)
    for f in frames:
        off = int(plan.frame_byte_offset[f]) + at
        for i in range(n):
            bad[off + i] ^= xor
    return bytes(bad)


@pytest.mark.parametrize("damage", ["clean", "one region", "two regions"])
def test_decode_tolerant_matches_jax(damage):
    """decode_tolerant: the JAX function's resyncs, segments, frames,
    MD5 verdict and PCM; the frames outside the damage equal the
    encoder's input."""
    data, pcm = _stream()
    if damage == "one region":
        data = _corrupt(data, (7,), 40, 8, 0xA5)
    elif damage == "two regions":
        data = _corrupt(data, (3, 11), 30, 4, 0x77)
    got = zflac_tpu_torch.decode_tolerant(data, device="cpu")
    want = zflac_tpu.decode_tolerant(data)
    assert got.stats == want.stats
    _same(got, want)
    exp = expected_output(pcm, 16).reshape(-1, 2)
    if damage == "clean":
        assert got.stats["resyncs"] == 0 and got.stats["md5_ok"]
        np.testing.assert_array_equal(got.samples, exp)
    else:
        assert got.stats["resyncs"] >= 1 and not got.stats["md5_ok"]
        np.testing.assert_array_equal(got.samples[12 * 1024:],
                                      exp[12 * 1024:])
