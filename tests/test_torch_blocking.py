"""The PyTorch port's decode_to_device (zflac_tpu_torch) against the JAX
package's on the CPU, for block geometry and chunking: the stereo
corpus streams of <= 16 bits with uncommon, padded or variable block
sizes, several chunks, the parallel anchor-split scan, and chunks that
each keep the geometry of their own scan where the JAX package
re-scans them with their union (tolerance zero)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from torch_slice import (  # noqa: E402
    BLOCKING_STREAMS,
    assert_same,
    check_card_layout,
    check_rows_engine,
    check_stream,
    class_caps,
)
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import native_indexer  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo  # noqa: E402
from zflac_tpu_torch.utils.timer import recording  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


@pytest.mark.parametrize("name", BLOCKING_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", BLOCKING_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("name", BLOCKING_STREAMS)
def test_card_layout_matches_jax(name, corpus):
    check_card_layout(name, corpus)


@pytest.mark.parametrize("name,kw", [
    ("lpc order 8", dict(chunk_frames=2)),
    ("lpc order 8", dict(chunk_frames=2, scan_workers=2)),
    ("constant heavy", dict(chunk_frames=2)),
    ("variable blocksize", dict(chunk_frames=2, scan_workers=3)),
    ("unknown length", dict(scan_workers=2)),
])
def test_chunked_matches_jax(name, kw, corpus):
    """Several chunks (with diverging geometries where chunk classes
    diverge), the parallel anchor-split scan and the probe frame
    estimate give what the JAX package gives."""
    data = corpus[name][0]
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu", **kw)
    ref = zflac_tpu.decode_to_device(data, **kw)
    if "chunk_frames" in kw:
        assert len(dd.chunks) > 1
    assert_same(dd, ref)


def _scan_chunks(data, **kw):
    """The port's stream_chunks of `data`, as decode_to_device scans
    them."""
    br = BitReader(data)
    return rt.stream_chunks(data, parse_metadata(br), br.pos // 8, **kw)


@pytest.fixture
def forced_scans(monkeypatch):
    """Counts the port's pack2_range calls that force a class set (the
    union re-scan the JAX package makes)."""
    calls = []
    real = native_indexer.pack2_range

    def counted(*args, **kw):
        if kw.get("force_class_np") is not None:
            calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(native_indexer, "pack2_range", counted)
    return calls


def test_natural_geometry_path(forced_scans, corpus):
    """Single-frame chunks of 'constant heavy' have diverging natural
    class sets. decode_to_device reconstructs each in its own geometry:
    no scan forces a class set, no re-scan key is reported, and the PCM
    is the JAX package's (which re-scans them with their union)."""
    data = corpus["constant heavy"][0]
    cks = _scan_chunks(data, chunk_frames=1)
    assert len({ck.spec_key() for ck in cks}) > 1
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          chunk_frames=1)
    assert forced_scans == []
    assert "rescan_ms" not in dd.stats
    assert len(dd.chunks) == len(cks)
    for pcm, ck in zip(dd.chunks, cks, strict=True):
        assert tuple(pcm.shape) == (ck.Fp, ck.Bp, ck.C)
    assert_same(dd, zflac_tpu.decode_to_device(data, chunk_frames=1))


@pytest.mark.parametrize("workers", [2, 4, 8])
def test_parallel_ranges_keep_their_own_frame_capacity(workers,
                                                       forced_scans,
                                                       corpus):
    """Under a forced parallel split of an 8-frame stream, each chunk's
    frame capacity is its own frame count (the card layout), not the
    whole stream's, and the PCM is the JAX package's."""
    data = corpus["constant heavy"][0]
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          scan_workers=workers)
    assert len(dd.chunks) > 1 and forced_scans == []
    for pcm, F in zip(dd.chunks, dd.num_frames, strict=True):
        assert pcm.shape[0] == F
    assert_same(dd, zflac_tpu.decode_to_device(data,
                                               scan_workers=workers))


def test_natural_chunks_upload_no_more_than_the_union(forced_scans):
    """A bench-like stream scanned in four ranges: the chunks
    decode_to_device uploads hold fewer bytes than the same ranges
    re-scanned with their union geometry and the whole stream's frame
    capacity, as the JAX package uploads them; decode_to_device's own
    scan forces no class set."""
    pcm = correlated_stereo(1 << 16, 16, seed=7)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=4096))
    br = BitReader(data)
    info = parse_metadata(br)
    chunks = rt.scan_pack2_chunks(data, br.pos // 8, info, 16, 4096, False,
                                  workers=4)
    assert len(chunks) == 4
    cks = [ck for _, ck in chunks]
    cnp, pnp, wide = class_caps(cks)
    union = [native_indexer.pack2_range(
        data, a, ck.landed, info, max_frames=16, force_fp=16,
        force_bp=4096, force_w=max(c.W for c in cks), force_class_np=cnp,
        force_patch_np=pnp, force_wide=wide) for a, ck in chunks]
    assert all(u.landed == ck.landed for u, ck in zip(union, cks))
    natural = sum(ck.device_buf.nbytes for ck in cks)
    assert natural < sum(u.device_buf.nbytes for u in union)
    forced = len(forced_scans)
    with recording() as rec:
        got = _scan_chunks(data, scan_workers=4)
    assert sum(ck.device_buf.nbytes for ck in got) == natural
    assert len(forced_scans) == forced and "rescan_ms" not in rec.stats


def test_mid_side_chunks_of_both_widths():
    """A 32-bit stream whose frames alternate independent and mid-side
    coding, in single-frame chunks: the mid-side chunks are wide (33-bit
    side channels, int64 values) and the others are not, where the JAX
    package widens them all. Every chunk's PCM is int32, and the whole
    is the JAX package's and the encoder's input."""
    pcm = correlated_stereo(8 * 256, 32, seed=3)
    data = encode(pcm, 44100, 32, EncoderConfig(
        block_size=256, stereo_mode=("independent", "mid_side")))
    cks = _scan_chunks(data, chunk_frames=1)
    assert [ck.wide for ck in cks] == [False, True] * 4
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          chunk_frames=1)
    assert {pcm_.dtype for pcm_ in dd.chunks} == {torch.int32}
    got = assert_same(dd, zflac_tpu.decode_to_device(data, chunk_frames=1))
    np.testing.assert_array_equal(got.interleaved, pcm.reshape(-1))
