"""Shared by the tests that hold the PyTorch port's decode_to_device
(zflac_tpu_torch) to the JAX package's, stream by stream, on the CPU.

Every corpus stream (zflac_tpu.testing.make_corpus) is in exactly one
group here, by what it exercises, and each group has its own test file,
so that the groups run in parallel under pytest-xdist's per-file
scheduling. test_torch_device.py checks that the groups cover the
corpus exactly.
"""

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
