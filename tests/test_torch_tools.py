"""The port's measuring and checking tools on the CPU, at small sizes:
tools/bench.py, bench_kernels.py and profile_pack2.py on `--device cpu`
at 2**14 samples print one JSON line with their keys; every tool that
defaults to the card raises without one; 20 fuzz iterations end in
decodes and typed errors only, and the fuzz's second-device check
fails a run whose device entries disagree; the sanitized scan library builds under
its own name and leaves the production one in place; the profile of
the scan engine builds and runs; and the playback example writes the
WAV payload the JAX package's example writes for the same stream and
period."""

import importlib.util
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zflac_tpu.index.native_indexer import native_available  # noqa: E402

from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.examples import playback  # noqa: E402
from zflac_tpu_torch.index import native_indexer as ni  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo  # noqa: E402
from zflac_tpu_torch.tools import (  # noqa: E402
    bench, bench_ab, bench_kernels, fuzz_native, profile_pack2, streams)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--samples", str(1 << 14), "--reps", "1"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "engine",
              "engine_wall_ms", "baseline_wall_ms", "bench_samples",
              "gpu_chip_msps", "gpu_chip_msps_24"}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_on_cpu(capsys):
    assert bench.main([*SMALL, "--device", "cpu"]) == 0
    res = _last_json(capsys)
    assert BENCH_KEYS <= set(res)
    assert res["engine"] == "torch" and res["device"] == "cpu"
    assert res["bench_samples"] == 2 << 14 and res["frames"] == 4
    assert res["md5_verified"] and res["timer"] == "host clock (cpu)"
    assert res["gpu_chip_msps"] > 0 and res["gpu_chip_msps_24"] > 0


def test_bench_kernels_on_cpu(capsys):
    assert bench_kernels.main([*SMALL, "--device", "cpu"]) == 0
    res = _last_json(capsys)
    # stream24 runs at half the samples, as the JAX tool's row does.
    for row, bps, n in (("stream16", 16, 1 << 14),
                        ("stream24", 24, 1 << 13)):
        r = res[row]
        assert r["bps"] == bps and r["pack2_msps"] > 0
        assert r["true_samples_per_dispatch"] == 2 * n
    k = res["kernels"]
    for name in ("rice16", "lpc2", "lpc2w"):
        assert k[f"{name}_ms"] > 0
    assert k["lpc2_shape"][0] == streams.BENCH_BLOCK


@pytest.mark.parametrize("bps", [16, 24, 32])
def test_profile_pack2_on_cpu(bps, capsys):
    """Every stage is cut at every bit depth, 33-bit side channels
    (bench32ms) included."""
    assert profile_pack2.main(["--bps", str(bps), *SMALL,
                               "--device", "cpu"]) == 0
    res = _last_json(capsys)
    assert list(res["stages_ms"]) == list(profile_pack2.STAGES)
    assert all(s["cumulative"] > 0 for s in res["stages_ms"].values())
    assert res["tail"] == ("packtail" if bps == 16 else "general")


def test_profile_stages_end_in_reconstruct_pack2():
    """Each stage's call gives what the stage functions give, and "full"
    is reconstruct_pack2's PCM."""
    from zflac_tpu_torch.runtime import device as rt

    data = streams.bench_stream("bench16", 1 << 14)
    _, buf, geom, cb, _ = bench_kernels.resident(data, torch.device("cpu"))
    fns = {s: profile_pack2.stage_fn(s, buf, geom, cb)
           for s in profile_pack2.STAGES}
    rows = rt.residual_rows(buf, geom)
    stack = rt.sorted_stack(rows, buf, geom, container_bits=cb)
    assert torch.equal(fns["rows"](), rows)
    assert torch.equal(fns["transpose"](), stack)
    assert torch.equal(fns["stack"]().t(), stack)
    inv = rt.tail_inputs(buf, geom)[0]
    assert torch.equal(fns["signal"](), rt.stream_rows(stack, inv))
    assert torch.equal(fns["full"](),
                       rt.reconstruct_pack2(buf, geom, container_bits=cb))
    assert fns["unpack"]().shape[1] == geom.Ssort


@pytest.mark.parametrize("tool", ["bench", "bench_kernels", "profile_pack2",
                                  "fuzz_native", "playback"])
def test_tools_raise_without_a_card(tool):
    """With no card and no --device cpu, each tool raises instead of
    measuring on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    mod = {"bench": bench, "bench_kernels": bench_kernels,
           "profile_pack2": profile_pack2, "fuzz_native": fuzz_native,
           "playback": playback}[tool]
    args = {"fuzz_native": ["--iters", "1"], "playback": []}.get(tool, SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


def test_fuzz_on_cpu():
    out = fuzz_native.fuzz(20, 0, "cpu", log=lambda m: None)
    assert set(out) == {"ok", "typed_error", "pack2_reconstructed"}
    assert out["ok"] + out["typed_error"] == 20 * len(fuzz_native.ENTRIES)
    assert out["typed_error"] > 0 and out["pack2_reconstructed"] > 0


def test_fuzz_checks_a_second_device():
    out = fuzz_native.fuzz(10, 0, "cpu", log=lambda m: None,
                           check_device="cpu")
    assert out["checked"] == 10 * len(fuzz_native.DEVICE_ENTRIES)
    assert out["ok"] + out["typed_error"] == 10 * len(fuzz_native.ENTRIES)


def test_fuzz_check_catches_a_wrong_answer(monkeypatch):
    """A pack2 reconstruction that differs by one bit on the checked
    run fails the fuzz."""
    real = fuzz_native.pack2_entry
    runs = []

    def wrong_on_the_check(data, device):
        out = real(data, device)
        runs.append(device)
        if out is not None and len(runs) % 2 == 0:
            out = out.copy()
            out.flat[0] ^= 1
        return out

    monkeypatch.setattr(fuzz_native, "pack2_entry", wrong_on_the_check)
    with pytest.raises(AssertionError, match="pack2: cpu gave a result, "
                       "cpu a result that differs"):
        fuzz_native.fuzz(20, 0, "cpu", log=lambda m: None,
                         check_device="cpu")


def test_sanitized_library_has_its_own_name(tmp_path):
    """A sanitized build goes to a file of its own, with its own stamp,
    and leaves the production library and stamp in place and fresh."""
    import shutil

    prod = ni.build()
    for f in (prod, prod + ".stamp"):
        shutil.copy2(f, tmp_path)
    mine = tmp_path / ni.LIB_NAME
    before = (mine.read_bytes(), os.path.getmtime(mine),
              (tmp_path / (ni.LIB_NAME + ".stamp")).read_text())
    so = ni.build(str(tmp_path), sanitize="ubsan")
    assert os.path.basename(so) == ni.lib_name("ubsan") != ni.LIB_NAME
    assert "-fsanitize=undefined" in open(so + ".stamp").read()
    assert (mine.read_bytes(), os.path.getmtime(mine),
            (tmp_path / (ni.LIB_NAME + ".stamp")).read_text()) == before
    assert ni.build(str(tmp_path), sanitize="") == str(mine)
    assert os.path.getmtime(mine) == before[1]


def test_profile_native_builds_and_runs(tmp_path):
    exe = tmp_path / "profile_native"
    subprocess.run(["g++", "-O1", "-march=native", "-std=c++20", "-fwrapv",
                    "-o", str(exe), os.path.join(
                        _REPO, "zflac_tpu_torch", "tools",
                        "profile_native.cpp"), "-lpthread"],
                   check=True, capture_output=True, timeout=600)
    path = tmp_path / "s.flac"
    path.write_bytes(streams.bench_stream("bench16", 1 << 14))
    out = subprocess.run([str(exe), str(path), "1"], check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "samples: 16384 x 2 ch, 16 bps" in out
    assert "full parallel decode+md5" in out and "md5 only" in out


def test_bench_ab_times_a_library():
    data = streams.bench_stream("bench16", 1 << 14)
    assert bench_ab.bench_so(ni.build(), data, reps=1) > 0


def _wav_frames(path):
    with wave.open(str(path), "rb") as w:
        return (w.getnchannels(), w.getframerate(),
                w.readframes(w.getnframes()))


@pytest.mark.parametrize("period", [512, 300])
def test_playback_matches_jax(period, tmp_path, monkeypatch):
    """The port's example on the CPU and the JAX package's
    examples/playback.py write the same WAV for the same stream and
    period, equal to the encoder's input, and exit 0."""
    pcm = correlated_stereo(20000, 16, seed=5)
    path = tmp_path / "s.flac"
    path.write_bytes(encode(pcm, 44100, 16, EncoderConfig(block_size=4096)))
    port_wav, jax_wav = tmp_path / "port.wav", tmp_path / "jax.wav"
    assert playback.main([str(path), "--period", str(period), "--out",
                          str(port_wav), "--device", "cpu"]) == 0

    spec = importlib.util.spec_from_file_location(
        "jax_playback", os.path.join(_REPO, "examples", "playback.py"))
    jax_playback = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_playback)
    monkeypatch.setattr(sys, "argv", ["playback.py", str(path), "--period",
                                      str(period), "--out", str(jax_wav)])
    assert jax_playback.main() == 0

    got, want = _wav_frames(port_wav), _wav_frames(jax_wav)
    assert got == want
    assert got[2] == pcm.astype("<i2").tobytes()
    assert np.frombuffer(got[2], "<i2").size == pcm.size
