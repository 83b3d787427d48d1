"""Malformed streams raise the port's typed errors (zflac_tpu_torch):
the 17 cases of tests/test_faulty.py, built with the port's own
encoder, CRC-8 and Python indexer, through its three host-reachable
decoders on the CPU: the oracle, decode (the torch engine) and
decode(engine="native"). Each case raises the exception class the JAX
test expects, or decodes where it expects a decode, and the JAX
package's decoders raise the class of the same name on the same bytes.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import errors  # noqa: E402
from zflac_tpu_torch.bitio import BitWriter  # noqa: E402
from zflac_tpu_torch.crc import crc8  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import build_plan_py  # noqa: E402
from zflac_tpu_torch.testing import tone_mix  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

DECODERS = {
    "oracle": zflac_tpu_torch.decode_oracle,
    "torch": lambda data, **kw: zflac_tpu_torch.decode(data, device="cpu",
                                                       **kw),
    "native": lambda data, **kw: zflac_tpu_torch.decode(
        data, engine="native", **kw),
}
# The JAX package's decoders of tests/test_faulty.py, beside the port's
# counterparts.
JAX_PAIRS = {"oracle": zflac_tpu.decode_oracle, "torch": zflac_tpu.decode}


def _stream(**cfg):
    pcm = tone_mix(2048, 2, 16, seed=1)
    return bytearray(encode(pcm, 44100, 16,
                            EncoderConfig(block_size=512, **cfg)))


def _frame_offsets(data):
    return build_plan_py(bytes(data)).frame_byte_offset


def _patch_frame_header(data, frame, transform):
    """Apply `transform` to the 4 header bytes of frame `frame` and fix
    up the header CRC-8 so crc-checking decoders behave identically."""
    data = bytearray(data)
    off = int(_frame_offsets(data)[frame])
    hdr = int.from_bytes(data[off:off + 4], "big")
    hdr = transform(hdr)
    data[off:off + 4] = hdr.to_bytes(4, "big")
    # find CRC position: 4 header bytes + coded number length
    first = data[off + 4]
    nbytes = 8 - ((first ^ 0xFF).bit_length())
    crc_pos = off + 4 + max(1, nbytes)
    data[crc_pos] = crc8(bytes(data[off:crc_pos]))
    return bytes(data)


def _frame_byte_patch(frame, at, value=None, xor=None):
    data = _stream()
    off = int(_frame_offsets(data)[frame])
    if xor is not None:
        data[off + at] ^= xor
    else:
        data[off + at] = value
    return bytes(data)


def _missing_streaminfo():
    # Signature followed by a last-block PADDING only.
    bw = BitWriter()
    bw.write_bytes(b"fLaC")
    bw.write_bits(1, 1)
    bw.write_bits(1, 7)       # padding
    bw.write_bits(0, 24)
    return bw.getvalue()


def _truncated_when_total_known():
    # Cut the last frame entirely: EOF with a known total is an error
    # (zflac.zig:344).
    data = _stream()
    return bytes(data[:int(_frame_offsets(data)[3])])


# name -> (bytes maker, decode kwargs, expected error class name or None
# for a decode, text the message must hold)
CASES = {
    "missing_signature": (
        lambda: b"XLaC" + bytes(_stream()[4:]), {}, "InvalidSignature", None),
    "truncated": (
        lambda: bytes(_stream()[:len(_stream()) * 2 // 3]), {},
        "EndOfStream", None),
    "invalid_metadata_type": (
        lambda: (bytes(_stream()[:4]) + bytes([0x80 | 99])
                 + bytes(_stream()[5:])), {}, "InvalidMetadataHeader", None),
    "missing_streaminfo": (_missing_streaminfo, {}, "MissingStreaminfo",
                           None),
    # A residual bit flipped in frame 1.
    "md5_mismatch": (lambda: _frame_byte_patch(1, 20, xor=0x10), {},
                     "InvalidChecksum", None),
    "crc_detects_before_md5": (lambda: _frame_byte_patch(1, 20, xor=0x10),
                               {"check_crc": True}, "InvalidChecksum",
                               "CRC"),
    # Frame 2's sample-rate code 44.1k -> 48k (zflac.zig:391).
    "sample_rate_change": (
        lambda: _patch_frame_header(
            _stream(), 2, lambda h: (h & ~(0xF << 8)) | (0b1010 << 8)),
        {}, "InconsistentParameters", None),
    "bit_depth_change": (  # 16 -> 8 bps
        lambda: _patch_frame_header(
            _stream(), 2, lambda h: (h & ~(0x7 << 1)) | (0b001 << 1)),
        {}, "InconsistentParameters", None),
    "channel_count_change": (  # stereo -> mono
        lambda: _patch_frame_header(
            _stream(stereo_mode="independent"), 2,
            lambda h: (h & ~(0xF << 4)) | (0b0000 << 4)),
        {}, "InconsistentParameters", None),
    # Decorrelation mode may change mid-stream (count stays 2): the
    # encoder's default cycling already produces this.
    "stereo_mode_change_is_legal": (
        lambda: bytes(_stream(stereo_mode=None)), {}, None, None),
    "reserved_block_size": (  # code 0
        lambda: _patch_frame_header(_stream(), 1, lambda h: h & ~(0xF << 12)),
        {}, "InvalidFrameHeader", None),
    "forbidden_sample_rate": (
        lambda: _patch_frame_header(_stream(), 1, lambda h: h | (0xF << 8)),
        {}, "InvalidFrameHeader", None),
    "invalid_coded_number": (lambda: _frame_byte_patch(1, 4, 0xFF), {},
                             "InvalidCodedNumber", None),
    # A lone continuation byte.
    "continuation_first_coded_number": (
        lambda: _frame_byte_patch(1, 4, 0x80), {}, "InvalidCodedNumber",
        None),
    "bad_sync": (lambda: _frame_byte_patch(1, 0, 0x00), {},
                 "InvalidFrameHeader", None),
    "garbage_after_final_frame_ok": (
        lambda: bytes(_stream()) + b"\x00" * 64, {}, None, None),
    "truncated_when_total_known": (_truncated_when_total_known, {},
                                   "EndOfStream", None),
}


def _outcome(decode, data, kw):
    """The name of the exception class decode raises, or None."""
    try:
        decode(data, **kw)
    except Exception as e:  # the class name is what the test compares
        return type(e).__name__
    return None


def test_cases_are_the_jax_suites():
    """The 17 cases of tests/test_faulty.py, one for one."""
    import test_faulty
    jax_cases = {n[len("test_"):] for n in vars(test_faulty.TestFaulty)
                 if n.startswith("test_")}
    assert jax_cases == set(CASES) and len(CASES) == 17


@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("case", list(CASES))
def test_faulty_raises_the_typed_error(case, decoder):
    make, kw, want, match = CASES[case]
    decode = DECODERS[decoder]
    if want is None:
        decode(make(), **kw)
        return
    with pytest.raises(getattr(errors, want), match=match):
        decode(make(), **kw)


@pytest.mark.parametrize("pair", list(JAX_PAIRS))
@pytest.mark.parametrize("case", list(CASES))
def test_jax_decoder_raises_the_same_class(case, pair):
    """The JAX package's decoder on the same bytes raises the class of
    the same name as the port's counterpart (or neither raises)."""
    make, kw, want, _ = CASES[case]
    data = make()
    got = _outcome(DECODERS[pair], data, kw)
    assert got == want
    assert _outcome(JAX_PAIRS[pair], data, kw) == got
