"""The PyTorch port's command line (zflac_tpu_torch.cli) and front door
(zflac_tpu_torch/__init__.py) against the JAX package's on the CPU:
both CLIs' main(argv) on corpus streams (16-bit stereo, 24-bit, 8-bit),
the port with --device cpu. decode (WAV, raw, a sample range, tolerant
on a corrupted stream), inspect, verify, encode and bench must write
the same bytes and print the same lines, up to the timing in brackets.
Tolerance zero."""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu import cli as jcli  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import cli as pcli  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

STREAMS = ("lpc order 8", "bps 24", "bps 8")
CPU = ["--device", "cpu"]


def _lines(capsys):
    """What was printed since the last call, the timing in brackets
    (milliseconds, rates, seconds) blanked."""
    out = capsys.readouterr().out
    return [re.sub(r"\(\d+\.\d+ ms, \d+\.\d+ Msamples/s\)|, \d+\.\d+s\)",
                   "(time)", line) for line in out.splitlines()]


def _both(capsys, jargs, pargs):
    """Run both CLIs; returns their (return code, printed lines)."""
    capsys.readouterr()
    jrc = jcli.main(jargs)
    jout = _lines(capsys)
    prc = pcli.main(pargs)
    return (jrc, jout), (prc, _lines(capsys))


@pytest.fixture
def stream(request, corpus, tmp_path):
    path = tmp_path / "in.flac"
    path.write_bytes(corpus[request.param][0])
    return str(path)


def _by_name(names=STREAMS):
    return pytest.mark.parametrize("stream", names, indirect=True)


@_by_name()
@pytest.mark.parametrize("raw", [False, True])
def test_decode_writes_the_same_file(stream, raw, tmp_path, capsys):
    jout, pout = str(tmp_path / "j.out"), str(tmp_path / "p.out")
    flags = ["--raw"] if raw else []
    (jrc, jl), (prc, pl) = _both(
        capsys, ["decode", stream, "-o", jout, *flags],
        ["decode", stream, "-o", pout, *flags, *CPU])
    assert jrc == prc == 0
    assert len(jl) == 2 and "(time)" in jl[0]
    assert [s.replace(jout, "F") for s in jl] == \
        [s.replace(pout, "F") for s in pl]
    with open(jout, "rb") as f, open(pout, "rb") as g:
        want, got = f.read(), g.read()
    assert got == want
    if raw:
        assert got == zflac_tpu.decode(stream).interleaved.tobytes()
    else:
        assert got[:4] == b"RIFF"


@_by_name()
@pytest.mark.parametrize("engine", ["torch", "native", "oracle"])
def test_decode_engines(stream, engine, tmp_path, capsys):
    """Each of the port's engines writes what the JAX CLI's default
    writes, and prints the same line."""
    jout, pout = str(tmp_path / "j.raw"), str(tmp_path / "p.raw")
    jengine = {"torch": "tpu"}.get(engine, engine)
    (jrc, jl), (prc, pl) = _both(
        capsys, ["decode", stream, "--raw", "--crc", "-o", jout,
                 "--engine", jengine],
        ["decode", stream, "--raw", "--crc", "-o", pout, "--engine",
         engine, *CPU])
    assert jrc == prc == 0 and jl[0] == pl[0]
    with open(jout, "rb") as f, open(pout, "rb") as g:
        assert g.read() == f.read()


@_by_name()
@pytest.mark.parametrize("rng", [("--start", "1000", "--count", "2500"),
                                 ("--start", "3000"), ("--count", "777")])
def test_decode_range(stream, rng, tmp_path, capsys):
    jout, pout = str(tmp_path / "j.raw"), str(tmp_path / "p.raw")
    (jrc, jl), (prc, pl) = _both(
        capsys, ["decode", stream, "--raw", "-o", jout, *rng],
        ["decode", stream, "--raw", "-o", pout, *rng, *CPU])
    assert jrc == prc == 0 and jl[0] == pl[0]
    with open(jout, "rb") as f, open(pout, "rb") as g:
        want = f.read()
        assert g.read() == want and len(want) > 0


@_by_name()
def test_decode_tolerant_on_a_corrupted_stream(stream, tmp_path, capsys):
    from zflac_tpu.index import build_plan
    with open(stream, "rb") as f:
        bad = bytearray(f.read())
    off = int(build_plan(bytes(bad)).frame_byte_offset[1]) + 20
    for i in range(8):
        bad[off + i] ^= 0xA5
    path = tmp_path / "bad.flac"
    path.write_bytes(bytes(bad))
    jout, pout = str(tmp_path / "j.raw"), str(tmp_path / "p.raw")
    (jrc, jl), (prc, pl) = _both(
        capsys, ["decode", str(path), "--tolerant", "--raw", "-o", jout],
        ["decode", str(path), "--tolerant", "--raw", "-o", pout, *CPU])
    assert jrc == prc == 0
    assert jl[0].startswith("recovered with") and jl[:2] == pl[:2]
    with open(jout, "rb") as f, open(pout, "rb") as g:
        assert g.read() == f.read()


@_by_name(STREAMS + ("variable blocksize", "surround 8ch 24bit"))
def test_inspect_prints_the_same_lines(stream, capsys):
    (jrc, jl), (prc, pl) = _both(
        capsys, ["inspect", stream, "--frames", "5"],
        ["inspect", stream, "--frames", "5"])
    assert jrc == prc == 0
    assert pl == jl and any(s.startswith("streaminfo:") for s in pl)
    assert sum(s.startswith("  frame ") for s in pl) >= 1


def test_inspect_prints_metadata(tmp_path, capsys):
    """Tags, a seek table and padding, from a stream that has them."""
    from zflac_tpu.encoder import EncoderConfig, encode
    from zflac_tpu.testing import tone_mix
    cfg = EncoderConfig(block_size=512, tags={"TITLE": "t", "ARTIST": "a"},
                        seektable_every=2048)
    path = tmp_path / "m.flac"
    path.write_bytes(encode(tone_mix(8192, 2, 16, seed=3), 44100, 16, cfg))
    (jrc, jl), (prc, pl) = _both(capsys, ["inspect", str(path)],
                                 ["inspect", str(path)])
    assert jrc == prc == 0 and pl == jl
    assert any(s.startswith("tag: ") for s in pl)
    assert any(s.startswith("seek table:") for s in pl)


@_by_name()
@pytest.mark.parametrize("crc", [False, True])
def test_verify_ok_and_fail(stream, crc, tmp_path, capsys):
    flags = ["--crc"] if crc else []
    (jrc, jl), (prc, pl) = _both(capsys, ["verify", stream, *flags],
                                 ["verify", stream, *flags, *CPU])
    assert jrc == prc == 0 and pl == jl and pl[0].startswith("OK: MD5")
    with open(stream, "rb") as f:
        bad = bytearray(f.read())
    bad[-40] ^= 0x10
    path = tmp_path / "bad.flac"
    path.write_bytes(bytes(bad))
    (jrc, jl), (prc, pl) = _both(capsys, ["verify", str(path), *flags],
                                 ["verify", str(path), *flags, *CPU])
    assert jrc == prc == 1 and pl == jl and pl[0].startswith("FAIL: ")


@_by_name()
def test_encode_writes_the_same_bytes(stream, tmp_path, capsys):
    """decode to WAV with the JAX CLI, then encode that WAV with both:
    the same FLAC bytes, which decode back to the WAV's samples."""
    wav = str(tmp_path / "in.wav")
    assert jcli.main(["decode", stream, "-o", wav]) == 0
    jout, pout = str(tmp_path / "j.flac"), str(tmp_path / "p.flac")
    extra = ["--block-size", "1024", "--lpc-order", "6", "--tag", "A=b",
             "--seektable", "4096"]
    (jrc, jl), (prc, pl) = _both(capsys, ["encode", wav, jout, *extra],
                                 ["encode", wav, pout, *extra])
    assert jrc == prc == 0
    assert jl[0].replace(jout, "F") == pl[0].replace(pout, "F")
    with open(jout, "rb") as f, open(pout, "rb") as g:
        want = f.read()
        assert g.read() == want
    a, ra, ba = jcli._read_wav(wav)
    b, rb, bb = pcli._read_wav(wav)
    assert (ra, ba) == (rb, bb)
    np.testing.assert_array_equal(a, b)


@_by_name()
def test_bench_prints_the_same_keys(stream, capsys):
    (jrc, jl), (prc, pl) = _both(capsys, ["bench", stream, "--reps", "2"],
                                 ["bench", stream, "--reps", "2", *CPU])
    assert jrc == prc == 0
    j, p = json.loads(jl[-1]), json.loads(pl[-1])
    assert j.keys() == p.keys() and j["frames"] == p["frames"]
    assert p["median_ms"] > 0 and p["msamples_per_s"] > 0


def test_cli_arguments():
    """--engine takes torch (default), native and oracle; --device
    defaults to cuda, so with no card a decoding subcommand raises as
    the library does and nothing moves to the CPU by itself."""
    for engine in ("auto", "tpu"):
        with pytest.raises(SystemExit):
            pcli.main(["decode", "x.flac", "--engine", engine])
    with pytest.raises(SystemExit):
        pcli.main([])


@_by_name(STREAMS[:1])
@pytest.mark.parametrize("cmd", [["decode"], ["decode", "--tolerant"],
                                 ["decode", "--start", "5"], ["verify"],
                                 ["bench"]])
def test_cli_defaults_to_the_card(stream, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main([cmd[0], stream, *cmd[1:]])


# ---- the front door ----

def test_front_door_binds_every_name_of_the_jax_package():
    names = [n for n in vars(zflac_tpu)
             if not n.startswith("_") and n not in (
                 # submodules that importing the package happens to bind
                 "errors", "result", "bitio", "crc", "oracle", "metadata",
                 "index", "plan", "runtime", "utils", "ops", "parallel",
                 "encoder", "testing", "cli")]
    assert {"format", "decode", "decode_oracle", "probe", "DecodedFLAC",
            "FlacError", "InvalidChecksum", "decode_to_device"} <= set(names)
    missing = [n for n in names if not hasattr(zflac_tpu_torch, n)]
    assert not missing, missing
    assert zflac_tpu_torch.__version__ == zflac_tpu.__version__
    for n in names:
        a, b = getattr(zflac_tpu, n), getattr(zflac_tpu_torch, n)
        if isinstance(a, type) and issubclass(a, Exception):
            assert issubclass(b, Exception) and b.__name__ == a.__name__
            assert b.__module__ == "zflac_tpu_torch.errors"
    assert zflac_tpu_torch.format.__name__ == "zflac_tpu_torch.format"
    assert zflac_tpu_torch.DecodedFLAC.__module__ == "zflac_tpu_torch.result"


@pytest.mark.parametrize("name", ["lpc order 8", "bps 24",
                                  "surround 8ch 24bit"])
def test_probe_and_oracle_match(name, corpus, tmp_path):
    """probe and decode_oracle equal the originals, from bytes and from
    a path."""
    import dataclasses
    data = corpus[name][0]
    path = tmp_path / "s.flac"
    path.write_bytes(data)
    want_meta = dataclasses.asdict(zflac_tpu.probe(data))
    want = zflac_tpu.decode_oracle(data, check_crc=True)
    for src in (data, str(path), path, bytearray(data)):
        assert dataclasses.asdict(zflac_tpu_torch.probe(src)) == want_meta
    for src in (data, str(path)):
        got = zflac_tpu_torch.decode_oracle(src, check_crc=True)
        assert isinstance(got, zflac_tpu_torch.DecodedFLAC)
        np.testing.assert_array_equal(got.interleaved, want.interleaved)
        assert (got.channels, got.sample_rate, got.bits_per_sample) == (
            want.channels, want.sample_rate, want.bits_per_sample)
