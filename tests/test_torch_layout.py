"""The card layout of the port's pack2 scan (zflac_tpu_torch), on the
CPU: the parallel scan's chunks are padded only as the CUDA kernels
need (Fp the frame count, class blocks and the patch table in multiples
of 32 lanes, Bp a multiple of 8), decode_to_device on those chunks
equals the JAX package's, stream_chunks' chunks (those of the sharded
call too) keep their own frames, and a scan library built from other
sources is never loaded."""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from torch_slice import assert_same  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import native_indexer as ni  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

BLOCK = 4096


def _ceil32(n):
    return -(-n // 32) * 32


def _stream(case):
    """Bench-like streams (correlated stereo, block 4096, the streams of
    test_torch_host.py's test_pack2_bench_like_chunks_match), one whose
    first two frames are silent (constant subframes: two classes in the
    first chunks) and one of 17 frames (odd frame counts)."""
    bps, mode, frames = {"16": (16, None, 16), "24": (24, None, 16),
                         "32 mid_side": (32, "mid_side", 16),
                         "silent lead-in": (16, None, 16),
                         "17 frames": (16, None, 17)}[case]
    pcm = correlated_stereo(frames * BLOCK, bps, seed=7)
    if case == "silent lead-in":
        pcm[:2 * BLOCK] = 0
    return encode(pcm, 44100, bps, EncoderConfig(
        block_size=BLOCK, **({"stereo_mode": mode} if mode else {})))


@pytest.mark.parametrize("case", ["16", "24", "32 mid_side",
                                  "silent lead-in", "17 frames"])
def test_card_chunks_match_jax(case):
    """scan_pack2_chunks in three ranges: every chunk's Fp is its frame
    count, its lanes (Ssort) are the sum of its class member counts each
    rounded up to 32, and decode_to_device over the same split gives
    the JAX package's frames, block sizes, PCM and MD5."""
    data = _stream(case)
    br = BitReader(data)
    info = parse_metadata(br)
    chunks = rt.scan_pack2_chunks(data, br.pos // 8, info, 4, BLOCK, False,
                                  workers=3)
    assert len(chunks) >= 3
    cks = [ck for _, ck in chunks]
    for ck in cks:
        assert ck.layout == "card" and ck.Fp == ck.F and ck.Bp == BLOCK
        assert ck.Ssort == sum(_ceil32(n) for _, n, _ in ck.classes)
        assert ck.n_patch_p == _ceil32(max(ck.n_patch, 1))
    if case == "silent lead-in":
        assert max(len(ck.classes) for ck in cks) >= 2
    if case == "17 frames":
        assert any(ck.F % 2 for ck in cks)

    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          scan_workers=3)
    assert len(dd.chunks) == 3
    for pcm, F in zip(dd.chunks, dd.num_frames, strict=True):
        assert tuple(pcm.shape) == (F, BLOCK, 2)
    assert_same(dd, zflac_tpu.decode_to_device(data, scan_workers=3))


def test_pack2_range_layouts(corpus):
    """The default layout is the JAX package's ("jax"), and its spec
    key has no layout tag; an unknown layout raises before any scan."""
    data = corpus["constant heavy"][0]
    br = BitReader(data)
    info = parse_metadata(br)
    jax_ck = ni.pack2_range(data, br.pos // 8, len(data), info)
    card = ni.pack2_range(data, br.pos // 8, len(data), info, layout="card")
    assert jax_ck.layout == "jax" and len(jax_ck.spec_key()) == 10
    assert card.spec_key() == (*card.spec_key()[:10], "card")
    assert card.device_buf.nbytes < jax_ck.device_buf.nbytes
    with pytest.raises(ValueError, match="unknown pack2 layout"):
        ni.pack2_range(data, br.pos // 8, len(data), info, layout="tpu")


@pytest.mark.parametrize("name", ["blocksize 16", "blocksize 1000",
                                  "constant heavy"])
def test_stream_chunks_keep_their_own_shape(name, corpus):
    """stream_chunks in chunks of at most 2 frames, as the sharded call
    scans them: each chunk's Fp is its own frame count and Bp the card
    layout's (the largest block rounded up to 8, at least 16, not the
    JAX function's multiple of 128), with 32-lane class blocks."""
    data = corpus[name][0]
    br = BitReader(data)
    info = parse_metadata(br)
    cks = rt.stream_chunks(data, info, br.pos // 8, chunk_frames=2)
    assert len(cks) > 1
    for ck in cks:
        assert ck.layout == "card" and ck.Fp == ck.F and 1 <= ck.F <= 2
        assert ck.Bp == -(-max(info.max_block_size, 16) // 8) * 8
        assert ck.Ssort == sum(_ceil32(n) for _, n, _ in ck.classes)


def test_scan_library_rebuilds_when_its_sources_change(tmp_path,
                                                       monkeypatch):
    """A library built from other sources is never loaded: a source that
    changes while the library stays newer than it (as a copy that keeps
    file times may leave them) makes the library stale, and build()
    compiles it again. The stamp's digest of the sources decides, not
    the files' times."""
    src = tmp_path / "src"
    src.mkdir()
    srcs = []
    for path in ni._SRCS:
        srcs.append(str(src / os.path.basename(path)))
        shutil.copyfile(path, srcs[-1])
    monkeypatch.setattr(ni, "_SRCS", tuple(srcs))
    flags = ni.cxx_flags(ni.sanitizers())
    so = ni.build(str(tmp_path / "lib"))
    assert ni._fresh(so, flags)
    built = os.stat(so).st_mtime
    with open(srcs[1], "a") as f:
        f.write("\n// changed\n")
    os.utime(srcs[1], (built - 100, built - 100))
    assert not ni._fresh(so, flags)
    assert ni.build(str(tmp_path / "lib")) == so
    assert ni._fresh(so, flags) and os.stat(so).st_mtime >= built
    stamp = open(so + ".stamp").read()
    assert "sources " in stamp and all(f in stamp for f in flags)


def test_three_classes_at_lanes_0_32_64():
    """A chunk of three classes (const, fixed, lpc8) in the card layout:
    its class blocks start at lanes 0, 32 and 64, its LPC lane slice at
    64, and decode_to_device gives the JAX package's PCM and MD5."""
    from zflac_tpu_torch.tools.streams import first_chunk, three_class_stream

    data = three_class_stream()
    ck = first_chunk(data)
    assert [(c, np_) for c, _, np_ in ck.classes] == [
        ("const", 32), ("fixed", 32), ("lpc8", 32)]
    buf, geom = rt.chunk_to_torch(ck, "cpu")
    rows_t = rt.residual_rows(buf, geom)
    (rows, _, _, _), = rt.lpc_class_inputs(rows_t, buf, geom).values()
    assert rows.data_ptr() - rows_t.data_ptr() == 64 * rows_t.element_size()
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu")
    assert tuple(dd.chunks[0].shape) == (7, 1024, 2)
    assert_same(dd, zflac_tpu.decode_to_device(data))
