"""The benchmark's frozen encoder: its streams decode bit for bit
through every port entry a cell times, on device="cpu", and the plain
reference gives back the PCM the encoder was given."""

import numpy as np
import pytest

import zflac_tpu_torch as port
from harness import flacenc, manifest, pool, reference, signals

CONFIGS = ["cd16_flac5", "librispeech16k"]


def _stream(name, seconds, seed, extra=0):
    cfg = manifest.config(name)
    fmt = cfg["format"]
    n = int(seconds * fmt["sample_rate"]) + extra
    pcm = signals.make(n, fmt, cfg["signal"], signals.generator(seed, "cpu"),
                       "cpu")
    data, side = flacenc.encode(pcm, fmt, cfg["encoder"], cfg["metadata"])
    return cfg, pcm.numpy(), data, side


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("extra", [0, 1, 4095])
def test_streams_decode_bit_exact(name, extra):
    cfg, pcm, data, side = _stream(name, 1.2, 11 + extra, extra)
    C = cfg["format"]["channels"]
    dd = port.decode_to_device(data, device="cpu")
    assert np.array_equal(dd.to_host().interleaved.reshape(-1, C), pcm)
    r = port.decode(data, device="cpu")
    assert np.array_equal(r.interleaved.reshape(-1, C), pcm)
    r = port.decode(data, engine="native", check_crc=True)
    assert np.array_equal(r.interleaved.reshape(-1, C), pcm)
    assert np.array_equal(reference.decode([side], C, "cpu")[0], pcm)


def test_oracle_agrees_on_a_short_stream():
    cfg, pcm, data, _ = _stream("cd16_flac5", 0.25, 5)
    r = port.decode_oracle(data)
    assert np.array_equal(r.interleaved.reshape(-1, 2), pcm)


def test_stream_shape_follows_the_config():
    cfg, pcm, data, side = _stream("cd16_flac5", 2.0, 3)
    info = port.probe(data)
    c = side.counts
    assert c["meta_bytes"] + c["frame_bytes"] == len(data)
    assert c["frames"] == len(side.block) == -(-len(pcm) // 4096)
    assert set(np.unique(side.chcode)) <= {1, 8, 9, 10}
    assert c["kinds"]["lpc"] > 0 and c["kinds"]["constant"] > 0
    assert info is not None


def test_same_seed_same_bytes_and_lengths():
    cfg = manifest.config("librispeech16k")
    tr = dict(manifest.traffic("utt.device"), pool=3)
    tr["lengths_s"] = dict(tr["lengths_s"], lo=1, hi=2)
    a = pool.build(cfg, tr, 99, "cpu")
    b = pool.build(cfg, tr, 99, "cpu")
    c = pool.build(cfg, tr, 100, "cpu")
    assert [x.data for x in a] == [x.data for x in b]
    assert [len(x.pcm) for x in a] == [len(x.pcm) for x in c]
    assert [x.data for x in a] != [x.data for x in c]


def test_pool_lengths_are_quantile_midpoints():
    tr = manifest.traffic("track.device")
    assert pool.lengths(tr, 44100) == [round(s * 44100) for s in
                                       (172.5, 217.5, 262.5, 307.5)]
    secs = np.array(pool.lengths(manifest.traffic("utt.host"), 16000)) / 16000
    assert 1 < secs.min() and secs.max() < 35 and abs(secs.mean() - 12.7) < 0.3
