"""Shared by the tests that hold the PyTorch port's decode_to_device
(zflac_tpu_torch) to the JAX package's, stream by stream, on the CPU.

Every corpus stream (zflac_tpu.testing.make_corpus) is in exactly one
group here, by what it exercises, and each group has its own test file,
so that the groups run in parallel under pytest-xdist's per-file
scheduling. test_torch_device.py checks that the groups cover the
corpus exactly.
"""

import dataclasses

import numpy as np

# Subframe types and their parameters.
SUBFRAME_STREAMS = (
    "constant heavy", "verbatim noise", "escaped partitions",
    "fixed order 0", "fixed order 1", "fixed order 2", "fixed order 3",
    "fixed order 4", "lpc order 1", "lpc order 2", "lpc order 8",
    "lpc order 16", "lpc order 32", "lpc precision 8", "lpc precision 15",
    "partition order 0", "partition order 8",
)
# Stereo decorrelation, bit depths, wasted bits and STREAMINFO fields.
FORMAT_STREAMS = (
    "stereo independent", "stereo left_side", "stereo side_right",
    "stereo mid_side", "bps 8", "bps 12", "bps 16", "bps from streaminfo",
    "channels 2", "wasted bits", "uncommon samplerate", "unknown length",
)
# Block sizes (padded to Bp 128-4608) and variable blocking.
BLOCKING_STREAMS = (
    "blocksize 16", "blocksize 192", "blocksize 254", "blocksize 512",
    "blocksize 576", "blocksize 725", "blocksize 1000", "blocksize 1152",
    "blocksize 1937", "blocksize 2304", "blocksize 4096", "blocksize 4608",
    "uncommon blocksize", "variable blocksize",
)
# 17-32 bits: the 32-bit container (lpc2w), and the 32-bit streams whose
# side channels carry 33-bit samples (wide chunks, lpc2w33).
HIRES_STREAMS = (
    "bps 20", "bps 24", "rice2", "samplerate 192k", "hi-res 24/96",
    "bps 32", "hi-res 32bit", "hi-res 32bit mid_side",
    "hi-res 32bit left_side",
)
# Channel counts other than two (the general tail).
CHANNEL_STREAMS = (
    "channels 1", "channels 3", "channels 4", "channels 5", "channels 6",
    "channels 7", "channels 8", "surround 8ch 24bit", "wasted bits 12of16",
)
# The whole corpus, for the tests that take every stream in one file.
ALL_STREAMS = (SUBFRAME_STREAMS + FORMAT_STREAMS + BLOCKING_STREAMS +
               HIRES_STREAMS + CHANNEL_STREAMS)


def with_total(data: bytes, total: int) -> bytes:
    """The stream with STREAMINFO's 36-bit total-samples field set to
    `total` (bytes 18-25: rate 20 | channels 3 | bps 5 | total 36)."""
    v = int.from_bytes(data[18:26], "big")
    v = (v & ~((1 << 36) - 1)) | total
    return data[:18] + v.to_bytes(8, "big") + data[26:]


def assert_same(dd, ref, verify_md5=True):
    """Same frames, block sizes and PCM (host and device assembly, both
    normalization domains) as the JAX DeviceDecoded `ref`. Returns the
    port's host result."""
    assert dd is not None and ref is not None
    assert dd.num_frames == ref.num_frames
    assert dd.total_samples == ref.total_samples
    for a, b in zip(dd.block_sizes, ref.block_sizes, strict=True):
        np.testing.assert_array_equal(a, b)
    got = dd.to_host(verify_md5=verify_md5)
    want = ref.to_host(verify_md5=verify_md5)
    np.testing.assert_array_equal(got.interleaved, want.interleaved)
    assert (got.channels, got.sample_rate, got.bits_per_sample) == (
        want.channels, want.sample_rate, want.bits_per_sample)
    for normalized in (True, False):
        np.testing.assert_array_equal(
            dd.interleaved_device(normalized).numpy(),
            np.asarray(ref.interleaved_device(normalized)))
    return got


def class_caps(cks):
    """Union class capacities (in PACK2_CLASSES order), patch capacity
    and wide flag over a list of the port's pack2 chunks: the force_*
    inputs that make a re-scan of each chunk produce one identical
    geometry (the JAX package's union re-scan; the port reconstructs
    each chunk in its own geometry)."""
    from zflac_tpu_torch.index.native_indexer import PACK2_CLASSES

    caps = {}
    for ck in cks:
        for name, cn, _ in ck.classes:
            caps[name] = max(caps.get(name, 0), cn)
    cnp = [caps.get(n, 0) for n in PACK2_CLASSES]
    pnp = max([ck.n_patch_p for ck in cks] + [1])
    wide = any(ck.wide for ck in cks)
    return cnp, pnp, wide


def check_stream(name, corpus):
    """decode_to_device on the CPU == zflac_tpu.decode_to_device, with
    the stream MD5 verified, and == the encoder's input."""
    import zflac_tpu
    import zflac_tpu_torch
    from conftest import expected_output

    data, pcm, _sr, bps = corpus[name]
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu")
    got = assert_same(dd, zflac_tpu.decode_to_device(data))
    np.testing.assert_array_equal(got.interleaved, expected_output(pcm, bps))


def _ceil(n, m):
    return -(-n // m) * m


def check_card_layout(name, corpus):
    """The whole stream as one chunk of the port's scan in the card
    layout: Fp is the frame count, Bp the largest block rounded up to 8
    (at least 16), each class block its member count rounded up to 32
    at a base that is a multiple of 32, the patch table its count
    rounded up to 32 (at least 32). Its reconstruct_pack2 on the CPU ==
    the JAX package's reconstruct_pack2 of the JAX package's own chunk
    (the "jax" layout) on the frames and samples both hold, [:F, :B]."""
    import jax.numpy as jnp
    from zflac_tpu.bitio import BitReader as JBitReader
    from zflac_tpu.index.native_indexer import pack2_range as jpack2_range
    from zflac_tpu.oracle import parse_metadata as jparse_metadata
    from zflac_tpu.runtime.device import reconstruct_pack2 as jreconstruct

    from zflac_tpu_torch import format as fmt
    from zflac_tpu_torch.bitio import BitReader
    from zflac_tpu_torch.index.native_indexer import pack2_range
    from zflac_tpu_torch.oracle import parse_metadata
    from zflac_tpu_torch.runtime import device as rt

    data = corpus[name][0]
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 20, layout="card")
    jbr = JBitReader(data)
    jinfo = jparse_metadata(jbr)
    jck = jpack2_range(data, jbr.pos // 8, len(data), jinfo,
                       max_frames=1 << 20)
    assert ck is not None and jck is not None
    F, B = ck.F, ck.B
    assert (F, B, ck.S, ck.W, ck.n_patch) == (jck.F, jck.B, jck.S, jck.W,
                                              jck.n_patch)
    assert ck.layout == "card" and ck.spec_key()[-1] == "card"
    assert ck.Fp == F and ck.Bp == _ceil(max(B, 16), 8)
    assert ck.n_patch_p == _ceil(max(ck.n_patch, 1), 32)
    assert [(c, n) for c, n, _ in ck.classes] == [
        (c, n) for c, n, _ in jck.classes]
    base = 0
    for _, n, np_ in ck.classes:
        assert base % 32 == 0 and np_ == _ceil(n, 32)
        base += np_
    assert ck.Ssort == base

    cb = fmt.container_bits(ck.bits_per_sample)
    buf, geom = rt.chunk_to_torch(ck, "cpu")
    got = rt.reconstruct_pack2(buf, geom, container_bits=cb).numpy()
    assert got.shape == (F, ck.Bp, ck.C)
    want = np.asarray(jreconstruct(
        jnp.asarray(jck.device_buf), spec=jck.spec_key(), num_channels=jck.C,
        container_bits=cb, do_decorrelate=jck.do_decorrelate,
        use_pallas=False))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got[:F, :B], want[:F, :B])


# 16-bit LPC streams whose rows-engine cases also run with safe_lpc=True
# (every LPC subframe in the int64 lpc_wide class: the lpc64 kernel).
SAFE_LPC_STREAMS = ("lpc order 8", "lpc order 32", "lpc precision 15",
                    "stereo mid_side")


def check_rows_engine(name, corpus):
    """The rows engine: zflac_tpu_torch.decode(engine="torch") on the
    CPU == zflac_tpu.decode(engine="tpu") == the encoder's input, with
    the stream MD5 verified by both (verify_md5 defaults to True); for
    SAFE_LPC_STREAMS also with safe_lpc=True."""
    import zflac_tpu
    import zflac_tpu_torch
    from conftest import expected_output

    data, pcm, _sr, bps = corpus[name]
    for safe_lpc in (False, True) if name in SAFE_LPC_STREAMS else (False,):
        got = zflac_tpu_torch.decode(data, engine="torch", device="cpu",
                                     safe_lpc=safe_lpc)
        want = zflac_tpu.decode(data, engine="tpu", safe_lpc=safe_lpc)
        assert got.stats["engine"] == "torch"
        np.testing.assert_array_equal(got.interleaved, want.interleaved)
        assert (got.channels, got.sample_rate, got.bits_per_sample) == (
            want.channels, want.sample_rate, want.bits_per_sample)
        np.testing.assert_array_equal(got.interleaved,
                                      expected_output(pcm, bps))


def assert_deep_equal(a, b, what=""):
    """Deep equality of plans, stream infos and their fields."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_deep_equal(getattr(a, f.name), getattr(b, f.name),
                              f"{what}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_deep_equal(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_deep_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what
