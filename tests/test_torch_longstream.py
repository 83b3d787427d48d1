"""The PyTorch port's long-stream decode (zflac_tpu_torch.parallel.
longstream) against the JAX package's on the CPU, on the same inputs
(the cases of tests/test_longstream.py): shard_index (anchors, landing
bytes, per-shard plans), decode_longstream for 2, 4 and 8 shards and a
24-bit stream, and the boundary exchange's chain check. Tolerance
zero."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import expected_output  # noqa: E402
from zflac_tpu.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.parallel import longstream as jlong  # noqa: E402
from zflac_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from zflac_tpu.testing import correlated_stereo, tone_mix  # noqa: E402

from zflac_tpu_torch.errors import InvalidFrameHeader  # noqa: E402
from zflac_tpu_torch.parallel import longstream as plong  # noqa: E402
from zflac_tpu_torch.parallel import make_mesh  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def _stream16():
    pcm = correlated_stereo(64 * 1024, 16, seed=9)
    return pcm, encode(pcm, 44100, 16, EncoderConfig(block_size=4096))


def _stream24():
    pcm = tone_mix(16 * 1024, 2, 24, seed=10)
    return pcm, encode(pcm, 96000, 24, EncoderConfig(block_size=2048))


def _jax_mesh(n):
    devs = jax.devices("cpu")
    assert len(devs) >= n
    return jmake_mesh(devs[:n])


def _same(got, want):
    np.testing.assert_array_equal(got.interleaved, want.interleaved)
    assert got.interleaved.dtype == want.interleaved.dtype
    assert (got.channels, got.sample_rate, got.bits_per_sample) == (
        want.channels, want.sample_rate, want.bits_per_sample)
    assert got.stats == want.stats


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("stream", [_stream16, _stream24])
def test_shard_index_matches_jax(shards, stream):
    """The same anchors, landing bytes and per-shard plan arrays."""
    _, data = stream()
    info, got = plong.shard_index(data, shards)
    jinfo, want = jlong.shard_index(data, shards)
    assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
    assert len(got) == len(want) > 1
    for (a, landed, plan), (ja, jlanded, jplan) in zip(got, want):
        assert (a, landed) == (ja, jlanded)
        for f in dataclasses.fields(plan):
            x, y = getattr(plan, f.name), getattr(jplan, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
    # The first shard starts at the first frame's byte.
    assert got[0][0] == jlong._first_frame_byte(data)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_longstream_matches_jax(shards):
    pcm, data = _stream16()
    got = plong.decode_longstream(data, shards, make_mesh(["cpu"] * shards))
    _same(got, jlong.decode_longstream(data, shards, _jax_mesh(shards)))
    assert got.stats["shards"] >= 1 and got.stats["engine"] == "longstream"
    np.testing.assert_array_equal(got.interleaved, expected_output(pcm, 16))


def test_longstream_highres_matches_jax():
    pcm, data = _stream24()
    got = plong.decode_longstream(data, 4, make_mesh(["cpu"] * 4))
    _same(got, jlong.decode_longstream(data, 4, _jax_mesh(4)))
    np.testing.assert_array_equal(got.interleaved, expected_output(pcm, 24))


def test_longstream_more_shards_than_devices():
    """Shard h runs on mesh[h % D]: 8 shards over 3 devices."""
    pcm, data = _stream16()
    got = plong.decode_longstream(data, 8, make_mesh(["cpu"] * 3))
    np.testing.assert_array_equal(got.interleaved, expected_output(pcm, 16))


def test_boundary_exchange_offsets_and_gather():
    """Prefix-sum offsets over the gathered rows; a participant whose
    window held no frame (anchor -1) adds nothing and breaks no chain."""
    rows = [(10, 50, 2, 100), (50, 90, 3, 150), (90, 120, 1, 40)]
    table, offsets = plong.boundary_exchange(rows)
    np.testing.assert_array_equal(table, np.array(rows, np.int64))
    np.testing.assert_array_equal(offsets, [0, 100, 250])

    def gather(flat):        # this participant is the second of four
        assert flat.dtype == np.int64 and flat.shape == (4,)
        return np.array([rows[0], tuple(flat), (-1, -1, 0, 0), rows[2]])

    table, offsets = plong.boundary_exchange(rows[1], gather=gather)
    assert table.shape == (4, 4)
    np.testing.assert_array_equal(offsets, [0, 100, 250, 250])


def test_broken_chain_raises():
    """A shard that does not land on the next one's anchor raises
    InvalidFrameHeader, from the rows and from a real stream whose
    second shard is made to land early."""
    with pytest.raises(InvalidFrameHeader, match="shard 0 landed at 49"):
        plong.boundary_exchange([(10, 49, 2, 100), (50, 90, 3, 150)])
    _, data = _stream16()
    _, shards = plong.shard_index(data, 4)
    rows = [[a, landed, p.num_frames, p.total_samples]
            for a, landed, p in shards]
    plong.boundary_exchange(rows)
    rows[1][1] -= 1
    with pytest.raises(InvalidFrameHeader, match="shard 1 landed"):
        plong.boundary_exchange(rows)


def test_longstream_broken_chain_raises(monkeypatch):
    """decode_longstream raises when the index of a range lands short
    of the next anchor."""
    real = plong.index_range

    def lands_short(data, start, stop, info, **kw):
        plan, landed = real(data, start, stop, info, **kw)
        return plan, landed - (1 if stop < len(data) else 0)

    monkeypatch.setattr(plong, "index_range", lands_short)
    _, data = _stream16()
    with pytest.raises(InvalidFrameHeader):
        plong.decode_longstream(data, 4, make_mesh(["cpu"] * 4))
