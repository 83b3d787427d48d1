"""The PyTorch port's multi-process decode (zflac_tpu_torch.parallel.
distributed) on the CPU: REAL processes over torch.distributed's gloo
backend, the cases of tests/test_distributed.py (long-stream with 2
processes; pack2 with 2 and 4 processes, with 2 processes of 2 and 4
local devices, and on 24-bit, 32-bit mid-side and 8-channel streams).
Every process must write the full stream, equal to the JAX package's
decode. A forced re-scan that lands elsewhere must raise in every
process. Tolerance zero.

Run as a script, this file is the worker of that last test: the
port's worker, and in process 1 alone the scan's forced re-scan is made
to land one byte late."""

import os
import sys


def _rescan_worker(argv) -> int:
    from zflac_tpu_torch.index import native_indexer
    from zflac_tpu_torch.parallel import distributed

    real = native_indexer.pack2_range

    def rescan_lands_late(*args, **kw):
        ck = real(*args, **kw)
        if ck is not None and kw.get("force_class_np") is not None:
            ck.landed += 1
        return ck

    if int(argv[3]) == 1:
        native_indexer.pack2_range = rescan_lands_late
    return distributed._worker_main(argv)


if __name__ == "__main__":
    sys.exit(_rescan_worker(sys.argv[1:]))

import socket  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.testing import correlated_stereo, tone_mix  # noqa: E402

from zflac_tpu_torch.errors import InvalidFrameHeader  # noqa: E402
from zflac_tpu_torch.parallel import distributed as pdist  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = ["-m", "zflac_tpu_torch.parallel.distributed"]
# Above the process group's own timeout, so that a process left alone
# in a collective fails by itself before the test gives up on it.
WAIT_S = pdist.GROUP_TIMEOUT_S + 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, data, nprocs, engine, n_local=1, worker=WORKER):
    """Start nprocs worker processes with n_local CPU devices each on
    one stream; returns (processes' return codes, their logs, their
    output paths)."""
    stream = tmp_path / "stream.flac"
    stream.write_bytes(data)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for rank in range(nprocs):
        out = tmp_path / f"out{rank}.npy"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, *worker, str(stream), str(out), coordinator,
             str(rank), str(nprocs), engine, ",".join(["cpu"] * n_local)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out_bytes, _ = p.communicate(timeout=WAIT_S)
            logs.append(out_bytes.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], logs, outs


def _run(tmp_path, data, nprocs, engine, n_local=1):
    """Every process exits 0 and writes the JAX package's decode."""
    rcs, logs, outs = _spawn(tmp_path, data, nprocs, engine, n_local)
    for rc, log in zip(rcs, logs):
        assert rc == 0, log
    ref = zflac_tpu.decode(data).interleaved
    for out, log in zip(outs, logs):
        got = np.load(out)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=log)
    return logs


def test_two_process_longstream(tmp_path):
    pcm = correlated_stereo(120000, 16, seed=11)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    logs = _run(tmp_path, data, 2, "longstream")
    for log in logs:
        assert "'engine': 'longstream-distributed'" in log, log
        assert "'shards': 2" in log and "'processes': 2" in log, log


def _run_pack2(tmp_path, data, nprocs, n_local):
    logs = _run(tmp_path, data, nprocs, "pack2", n_local)
    for log in logs:
        assert "'engine': 'pack2-distributed'" in log, log
        assert f"'processes': {nprocs}" in log, log
        assert f"'shards': {nprocs * n_local}" in log, log
    return logs


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_process_pack2(tmp_path, nprocs):
    pcm = correlated_stereo(60000, 16, seed=12)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    _run_pack2(tmp_path, data, nprocs, 1)


@pytest.mark.parametrize("n_local", [2, 4])
def test_multi_process_pack2_two_level(tmp_path, n_local):
    """2 processes x L local devices each: D = 2 L byte ranges."""
    pcm = correlated_stereo(60000, 16, seed=14)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    _run_pack2(tmp_path, data, 2, n_local)


@pytest.mark.parametrize("case", ["24bit", "32bit_mid_side", "8ch"])
def test_multi_process_pack2_formats(tmp_path, case):
    """24-bit (lpc2w), 32-bit mid-side (wide chunks: the wide flag
    crosses processes in the geometry row) and 8 channels."""
    if case == "24bit":
        pcm = tone_mix(40000, 2, 24, seed=15)
        data = encode(pcm, 96000, 24, EncoderConfig(block_size=1024))
    elif case == "32bit_mid_side":
        pcm = correlated_stereo(30000, 32, seed=16)
        data = encode(pcm, 48000, 32,
                      EncoderConfig(block_size=1024,
                                    stereo_mode="mid_side"))
    else:
        pcm = tone_mix(20000, 8, 16, seed=17)
        data = encode(pcm, 48000, 16, EncoderConfig(block_size=1024))
    _run_pack2(tmp_path, data, 2, 1)


def test_pack2_falls_back_together(tmp_path):
    """More byte ranges than frame starts: a process is left with no
    range, its flag crosses, and every process takes the long-stream
    path together."""
    pcm = correlated_stereo(3 * 4096, 16, seed=18)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=4096))
    logs = _run(tmp_path, data, 2, "pack2", 4)
    for log in logs:
        assert "'engine': 'longstream-distributed'" in log, log


def test_rescan_that_lands_elsewhere_raises_in_every_process(tmp_path):
    """The forced union re-scan must land where the natural scan did.
    Process 1's alone lands late: the outcome is exchanged, so EVERY
    process raises InvalidFrameHeader at once (none raises or falls
    back alone and leaves the others waiting in a collective until the
    group's timeout)."""
    pcm = correlated_stereo(60000, 16, seed=12)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    t = time.monotonic()
    rcs, logs, outs = _spawn(tmp_path, data, 2, "pack2",
                             worker=[os.path.abspath(__file__)])
    assert time.monotonic() - t < pdist.GROUP_TIMEOUT_S
    for rc, log, out in zip(rcs, logs, outs):
        assert rc != 0 and "InvalidFrameHeader" in log, log
        assert "process(es) [1]" in log and "geometry mismatch" in log, log
        assert not out.exists()


def test_world_of_one(monkeypatch):
    """Outside any process group the functions run as a world of one
    (as the JAX functions do in a single process), on local CPU
    devices; a re-scan that lands elsewhere raises there too."""
    from zflac_tpu_torch.index import native_indexer

    pcm = correlated_stereo(60000, 16, seed=12)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    jref = zflac_tpu.decode(data)
    ref, frames = jref.interleaved, jref.stats["frames"]
    r = pdist.decode_pack2_distributed(data, devices=["cpu"] * 3)
    assert r.stats == {"shards": 3, "processes": 1, "frames": frames,
                       "engine": "pack2-distributed"}
    np.testing.assert_array_equal(r.interleaved, ref)
    r = pdist.decode_longstream_distributed(data, device="cpu")
    assert r.stats == {"shards": 1, "processes": 1, "frames": frames,
                       "engine": "longstream-distributed"}
    np.testing.assert_array_equal(r.interleaved, ref)

    real = native_indexer.pack2_range

    def rescan_lands_late(*args, **kw):
        ck = real(*args, **kw)
        if ck is not None and kw.get("force_class_np") is not None:
            ck.landed += 1
        return ck

    monkeypatch.setattr(native_indexer, "pack2_range", rescan_lands_late)
    with pytest.raises(InvalidFrameHeader, match="geometry mismatch"):
        pdist.decode_pack2_distributed(data, devices=["cpu"] * 2)


def test_sample_count_mismatch_raises(monkeypatch):
    """The completeness check: a device-side sample count that differs
    from the gathered frame tables raises InvalidChecksum."""
    from zflac_tpu_torch.errors import InvalidChecksum

    pcm = correlated_stereo(20000, 16, seed=19)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    real = pdist.chunk_samples
    monkeypatch.setattr(pdist, "chunk_samples",
                        lambda buf, geom: real(buf, geom) + 1)
    with pytest.raises(InvalidChecksum, match="sample-count mismatch"):
        pdist.decode_pack2_distributed(data, devices=["cpu"])


def test_stop_cut_in_a_world_of_one(corpus):
    """A STREAMINFO total at a frame start cuts the gathered PCM there
    (through apply_stop_cut), as the JAX package's decode cuts it."""
    from torch_slice import with_total

    data = corpus["lpc order 8"][0]
    cut = with_total(data, 3072)
    ref = zflac_tpu.decode(cut, verify_md5=False)
    assert ref.num_samples == 3072
    r = pdist.decode_pack2_distributed(cut, verify_md5=False,
                                       devices=["cpu"] * 2)
    assert r.num_samples == ref.num_samples
    assert r.interleaved.dtype == ref.interleaved.dtype
    np.testing.assert_array_equal(r.interleaved, ref.interleaved)
