"""The rows plan's parallel index (index/native/indexer.cpp
`parallel_index` and `pack_segments`), on streams over 1 MiB: the plan
whose segments each thread packs equals, array for array, the plan of
one sequential scan (ZFLAC_TPU_SEQ_INDEX=1) and the JAX package's plan;
each row is zero past its block; `decode`'s stats carry the index's
phases and counters; a false anchor makes the parallel parse fall back
and is counted; and the plan's rows are the index's own buffer, not a
copy."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zflac_tpu.index import native_indexer as jni  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import native_indexer as ni  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import decode as rdecode  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo  # noqa: E402
from zflac_tpu_torch.utils.timer import recording  # noqa: E402

from torch_slice import assert_deep_equal  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (ni.native_available() and jni.native_available()),
    reason="native indexer unavailable")

MIB = 1 << 20
BLOCK = 4096
# name -> (bits per sample, samples a channel, encoder options): 2-3 MiB
# each, the last frame short. Partition order 0 keeps the encoder's
# Rice search to one partition a subframe.
STREAMS = {
    "stereo16": (16, 800_000, {}),
    "hires24": (24, 500_000, {}),
    "mid_side32": (32, 350_000, {"stereo_mode": "mid_side"}),
}


@functools.lru_cache(maxsize=None)
def _stream(name: str):
    bps, n, opts = STREAMS[name]
    pcm = correlated_stereo(n, bps, seed=len(name))
    data = encode(pcm, 44100, bps, EncoderConfig(
        block_size=BLOCK, partition_order=0, **opts))
    assert 2 * MIB <= len(data) <= 4 * MIB, (name, len(data))
    return data, pcm


def _declare_total(data: bytes, total: int) -> bytes:
    """`data` with STREAMINFO's 36-bit total of samples set to `total`
    (STREAMINFO is the first block: its body starts at byte 8, and the
    total takes the low 4 bits of byte 21 and bytes 22-25)."""
    out = bytearray(data)
    out[21] = (out[21] & 0xF0) | (total >> 32)
    out[22:26] = (total & 0xFFFFFFFF).to_bytes(4, "big")
    assert parse_metadata(BitReader(bytes(out))).total_samples == total
    return bytes(out)


def _plan(data, emit_groups=False):
    """The port's native plan and the stats its call recorded."""
    with recording() as rec:
        plan = ni.build_plan_native(data, emit_groups=emit_groups)
    return plan, rec.stats


def _check_tails(plan):
    """Each row is zero from its subframe's block size to the plan's
    largest block."""
    bs = np.repeat(plan.block_size, plan.channels)
    assert len(bs) == plan.rows.shape[0]
    cols = np.arange(plan.rows.shape[1])
    assert not plan.rows[cols[None, :] >= bs[:, None]].any()
    assert (bs < plan.rows.shape[1]).any()   # the short last frame


# case -> (stream, declared total as a share of its frames or None,
# emit_groups, ZFI_THREADS or None for every core).
CASES = {
    "stereo16": ("stereo16", None, False, None),
    "hires24": ("hires24", None, False, None),
    "mid_side32": ("mid_side32", None, False, None),
    "stereo16_cut": ("stereo16", 0.6, False, None),
    "stereo16_groups": ("stereo16", None, True, None),
    "stereo16_3_threads": ("stereo16", None, False, "3"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_plan_equals_sequential(case, monkeypatch):
    """The parallel plan of a 2-4 MiB stream equals the sequential plan
    and the JAX package's, dtype, shape and bytes; its rows are zero
    past each block. "cut": STREAMINFO declares 60 % of the frames, on
    a frame boundary, so the later segments' frames are dropped."""
    name, cut, groups, threads = CASES[case]
    data, _ = _stream(name)
    if threads:
        monkeypatch.setenv("ZFI_THREADS", threads)
    frames = -(-STREAMS[name][1] // BLOCK)
    if cut is not None:
        data = _declare_total(data, int(frames * cut) * BLOCK)
    par, stats = _plan(data, groups)
    assert stats["plan_segments"] > 1 and stats["plan_fallbacks"] == 0
    if threads:
        assert stats["plan_segments"] == int(threads)
    assert par.num_frames == (int(frames * cut) if cut else frames)
    assert par.rows.dtype == (np.int64 if STREAMS[name][0] > 16
                              else np.int32)
    if name == "mid_side32":
        assert (par.channel_code == 10).all()   # 33-bit side channels
    assert (par.groups is not None) == groups
    assert_deep_equal(par, jni.build_plan_native(data, emit_groups=groups),
                      case)
    monkeypatch.setenv("ZFLAC_TPU_SEQ_INDEX", "1")
    seq, seq_stats = _plan(data, groups)
    assert seq_stats["plan_segments"] == 1
    assert seq_stats["plan_fallbacks"] == 0
    assert_deep_equal(par, seq, case)
    for plan in (par, seq):
        assert plan.rows.shape == (plan.num_subframes, BLOCK)
        if cut is None:
            _check_tails(plan)


def _false_anchor_stream():
    """Verbatim 16-bit stereo whose samples, in both channels, are
    copies of a whole valid frame of a small stream, back to back: the
    anchor the second segment's search finds is one of them, so the
    first segment does not land on it."""
    small = encode(correlated_stereo(24, 16, seed=1)[:, :1], 44100, 16,
                   EncoderConfig(block_size=24))
    br = BitReader(small)
    parse_metadata(br)
    frame = small[br.pos // 8:]
    n = 300_000
    tiled = (frame * (2 * n // len(frame) + 1))[:2 * n]
    ch = np.frombuffer(tiled, dtype=">i2").astype(np.int16)
    pcm = np.stack([ch, np.roll(ch, 7)], axis=1)
    data = encode(pcm, 44100, 16, EncoderConfig(
        block_size=BLOCK, subframe_mode="verbatim",
        stereo_mode="independent"))
    assert len(data) > MIB
    return data, pcm


def test_decode_stats_carry_the_index_phases(monkeypatch):
    """`decode`'s stats carry plan_segments, plan_fallbacks,
    plan_parse_ms and plan_pack_ms: over 1 MiB several segments and no
    fallback, under 1 MiB one segment; a false anchor counts one
    fallback, and the plan of the sequential scan that follows equals
    the JAX package's. The rows the plan hands on are the index's own
    buffer, not a copy."""
    data, pcm = _stream("stereo16")
    r = zflac_tpu_torch.decode(data, device="cpu")
    np.testing.assert_array_equal(r.samples, pcm.astype(np.int16))
    assert r.stats["plan_segments"] > 1
    assert r.stats["plan_fallbacks"] == 0
    assert r.stats["plan_parse_ms"] > 0 and r.stats["plan_pack_ms"] > 0

    small = encode(correlated_stereo(40_000, 16, seed=2), 44100, 16,
                   EncoderConfig(block_size=BLOCK))
    assert len(small) < MIB
    r = zflac_tpu_torch.decode(small, device="cpu")
    assert r.stats["plan_segments"] == 1
    assert r.stats["plan_fallbacks"] == 0
    assert r.stats["plan_parse_ms"] > 0 and r.stats["plan_pack_ms"] > 0

    bad, bad_pcm = _false_anchor_stream()
    monkeypatch.setenv("ZFI_THREADS", "2")
    r = zflac_tpu_torch.decode(bad, device="cpu")
    np.testing.assert_array_equal(r.samples, bad_pcm)
    assert r.stats["plan_fallbacks"] == 1
    assert r.stats["plan_segments"] == 1
    assert_deep_equal(ni.build_plan_native(bad),
                      jni.build_plan_native(bad), "false anchor")

    plan = rdecode.build_plan(data)
    assert not plan.rows.flags.owndata
    base = plan.rows
    while isinstance(base, np.ndarray):
        base = base.base
    assert not isinstance(base, np.ndarray) and base is not None
    assert np.ctypeslib.as_array(base).ctypes.data == plan.rows.ctypes.data
    assert plan.rows.flags.writeable and plan.rows.flags.c_contiguous
