"""The PyTorch port's decode_to_device (zflac_tpu_torch) against the JAX
package's on the CPU, for block geometry and chunking: the stereo
corpus streams of <= 16 bits with uncommon, padded or variable block
sizes, several chunks, the parallel anchor-split scan and the
union-geometry re-scan (tolerance zero)."""

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
    check_rows_engine,
    check_stream,
)
from zflac_tpu_torch.runtime import device as rt  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


@pytest.mark.parametrize("name", BLOCKING_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", BLOCKING_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("name,kw", [
    ("lpc order 8", dict(chunk_frames=2)),
    ("lpc order 8", dict(chunk_frames=2, scan_workers=2)),
    ("constant heavy", dict(chunk_frames=2)),
    ("variable blocksize", dict(chunk_frames=2, scan_workers=3)),
    ("unknown length", dict(scan_workers=2)),
])
def test_chunked_matches_jax(name, kw, corpus):
    """Several chunks (and the union-geometry re-scan where chunk
    classes diverge), the parallel anchor-split scan and the probe
    frame estimate give what the JAX package gives."""
    data = corpus[name][0]
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu", **kw)
    ref = zflac_tpu.decode_to_device(data, **kw)
    if "chunk_frames" in kw:
        assert len(dd.chunks) > 1
    assert_same(dd, ref)


def test_union_rescan_path(corpus):
    """Single-frame chunks of 'constant heavy' have diverging natural
    class sets, so decode_to_device re-scans them with the union
    geometry: one chunk shape, and the JAX package's PCM."""
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    data = corpus["constant heavy"][0]
    br = BitReader(data)
    info = parse_metadata(br)
    chunks = rt.scan_pack2_chunks(data, br.pos // 8, info, 1,
                                  rt._bucket_block(info.max_block_size),
                                  False)
    assert len({ck.spec_key() for _, ck in chunks}) > 1
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          chunk_frames=1)
    assert len(dd.chunks) == len(chunks)
    assert len({tuple(c.shape) for c in dd.chunks}) == 1
    assert_same(dd, zflac_tpu.decode_to_device(data, chunk_frames=1))


def test_union_rescan_must_land_where_the_scan_did(monkeypatch, corpus):
    """A union re-scan that lands elsewhere than the natural scan of
    the same range declines the fast path (returns None). The port
    scans with its own copy of the native indexer."""
    from zflac_tpu_torch.index import native_indexer

    real = native_indexer.pack2_range

    def rescan_lands_late(*args, **kw):
        ck = real(*args, **kw)
        if ck is not None and kw.get("force_class_np") is not None:
            ck.landed += 1
        return ck

    monkeypatch.setattr(native_indexer, "pack2_range", rescan_lands_late)
    data = corpus["constant heavy"][0]
    assert zflac_tpu_torch.decode_to_device(data, device="cpu",
                                            chunk_frames=1) is None
