"""The PyTorch port's multi-device sharding (zflac_tpu_torch.parallel.
shard) against the JAX package's (zflac_tpu.parallel.shard) on the CPU,
on the same inputs: shard_plan's arrays and meta, reconstruct_sharded
(the cases of tests/test_sharding.py), decode_to_device_sharded with
sharded_to_host (the cases of tests/test_sharding_pack2.py, a stream
whose STREAMINFO total forces the stop cut, chunks whose class sets
diverge, and an empty result). The
port runs on a list of CPU devices, the JAX package on its virtual
8-device CPU mesh. Tolerance zero."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402

import zflac_tpu  # noqa: E402
from zflac_tpu import format as fmt  # noqa: E402
from zflac_tpu.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu.index import build_plan_py as jbuild_plan_py  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.parallel import shard as jshard  # noqa: E402
from zflac_tpu.testing import correlated_stereo, tone_mix  # noqa: E402

from zflac_tpu_torch import _kernels  # noqa: E402
from zflac_tpu_torch.index import build_plan_py  # noqa: E402
from zflac_tpu_torch.parallel import make_mesh, reconstruct_sharded  # noqa: E402
from zflac_tpu_torch.parallel import shard as pshard  # noqa: E402
from zflac_tpu_torch.runtime.decode import _run_reconstruct  # noqa: E402

from torch_slice import with_total  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def _jax_mesh(n):
    devs = jax.devices("cpu")
    assert len(devs) >= n, f"need {n} cpu devices, have {len(devs)}"
    return jshard.make_mesh(devs[:n])


def _cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _stream(frames):
    pcm = correlated_stereo(frames * 512, 16, seed=frames)
    return encode(pcm, 44100, 16, EncoderConfig(block_size=512))


def _stream_4ch_24bit():
    pcm = tone_mix(6 * 256, 4, 24, seed=5)
    return encode(pcm, 96000, 24, EncoderConfig(block_size=256))


def test_make_mesh():
    """A mesh is a list of resolved torch devices; with no card the
    default (every visible CUDA device) and a CUDA entry raise."""
    assert _cpu_mesh(3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(["cpu", "cuda:0"])


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("case", [8, 13, "4ch 24bit"])
def test_shard_plan_matches_jax(n_dev, case):
    data = _stream_4ch_24bit() if case == "4ch 24bit" else _stream(case)
    arrays, meta = pshard.shard_plan(build_plan_py(data), n_dev)
    jarrays, jmeta = jshard.shard_plan(jbuild_plan_py(data), n_dev)
    assert meta == jmeta
    assert list(arrays) == list(jarrays)
    for name, a in arrays.items():
        assert a.dtype == jarrays[name].dtype, name
        np.testing.assert_array_equal(a, jarrays[name], err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("frames", [8, 13])
def test_sharded_matches_jax(n_dev, frames):
    """reconstruct_sharded: the JAX function's PCM and total, and the
    port's single-device reconstruction."""
    data = _stream(frames)
    got, total = reconstruct_sharded(build_plan_py(data), _cpu_mesh(n_dev))
    want, jtotal = jshard.reconstruct_sharded(jbuild_plan_py(data),
                                              _jax_mesh(n_dev))
    assert got.dtype == want.dtype and total == jtotal
    np.testing.assert_array_equal(got, want)
    single = _run_reconstruct(build_plan_py(data), "cpu")
    np.testing.assert_array_equal(got, single[:, :got.shape[1]])


def test_sharded_highres_multichannel_matches_jax():
    data = _stream_4ch_24bit()
    got, total = reconstruct_sharded(build_plan_py(data), _cpu_mesh(4))
    want, jtotal = jshard.reconstruct_sharded(jbuild_plan_py(data),
                                              _jax_mesh(4))
    assert got.dtype == want.dtype and total == jtotal
    np.testing.assert_array_equal(got, want)


def test_sharded_odd_block_size():
    """A block size that is no multiple of 8 (the lpc kernels' time
    groups): the rows are padded for the device and cut back."""
    pcm = correlated_stereo(5 * 725, 16, seed=3)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=725))
    got, total = reconstruct_sharded(build_plan_py(data), _cpu_mesh(2))
    want, jtotal = jshard.reconstruct_sharded(jbuild_plan_py(data),
                                              _jax_mesh(2))
    assert got.shape == want.shape and total == jtotal
    np.testing.assert_array_equal(got, want)


# Exact corpus keys, the cases of tests/test_sharding_pack2.py. A name
# miss is a FAILURE, not a skip.
_CASES = ["lpc order 8", "fixed order 2", "stereo mid_side",
          "stereo left_side", "stereo side_right", "wasted bits",
          "blocksize 1000", "blocksize 16", "escaped partitions",
          "lpc order 32", "hi-res 24/96", "surround 8ch 24bit",
          "partition order 8", "variable blocksize",
          "hi-res 32bit", "hi-res 32bit mid_side",
          "hi-res 32bit left_side"]


def _same_sharded(data, n_dev=8, **kw):
    """decode_to_device_sharded + sharded_to_host equal the JAX pair:
    PCM, frames, block sizes, rounds and the sample count. Returns the
    port's (rounds, meta, host PCM)."""
    mesh = _cpu_mesh(n_dev)
    r = pshard.decode_to_device_sharded(data, mesh, **kw)
    jr = jshard.decode_to_device_sharded(data, _jax_mesh(n_dev), **kw)
    assert r is not None and jr is not None, "declined an admissible stream"
    (out, meta), (jout, jmeta) = r, jr
    assert isinstance(out, list) and len(out) == meta["rounds"]
    for rnd, jrnd in zip(out, jout, strict=True):
        assert len(rnd) == n_dev
        for t in rnd:
            assert tuple(t.shape) == jrnd.shape[1:]
            assert t.dtype == getattr(torch, jrnd.dtype.name)
    host = pshard.sharded_to_host(out, meta)
    jhost = jshard.sharded_to_host(jout, jmeta)
    assert host.dtype == jhost.dtype
    np.testing.assert_array_equal(host, jhost)
    assert meta.keys() == jmeta.keys()
    for key in ("channels", "sample_rate", "bits_per_sample", "num_frames",
                "md5", "rounds"):
        assert meta[key] == jmeta[key], key
    for a, b in zip(meta["block_sizes"], jmeta["block_sizes"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert int(meta["psum_samples"]) == int(
        np.asarray(jmeta["psum_samples"])[0])
    return out, meta, host


@pytest.mark.parametrize("name", _CASES)
def test_sharded_pack2_matches_jax(name, corpus):
    assert name in corpus, (
        f"corpus case {name!r} missing: fix the name, don't skip")
    data = corpus[name][0]
    _kernels.launches.clear()
    _out, meta, host = _same_sharded(data)
    assert sum(_kernels.launches.values()) == 0     # the CPU route
    ref = zflac_tpu.decode(data, engine="native")
    shift = fmt.normalization_shift(meta["bits_per_sample"])
    np.testing.assert_array_equal(
        host, ref.interleaved >> shift if shift else ref.interleaved)
    # bssub counts per subframe, i.e. samples x channels.
    assert int(meta["psum_samples"]) == meta["channels"] * sum(
        int(b.sum()) for b in meta["block_sizes"])


def test_sharded_pack2_single_vs_multi_device(corpus):
    data = corpus["lpc order 8"][0]
    _, _, host1 = _same_sharded(data, n_dev=1)
    _, _, host8 = _same_sharded(data, n_dev=8)
    np.testing.assert_array_equal(host1, host8)


def test_sharded_pack2_multi_round():
    """24 frames in 4-frame chunks over 2 devices: 3 rounds."""
    pcm = tone_mix(24 * 256, 2, 16, seed=31)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=256))
    out, meta, host = _same_sharded(data, n_dev=2, chunk_frames=4)
    assert meta["rounds"] == 3 and len(out) == 3
    np.testing.assert_array_equal(
        host, zflac_tpu.decode(data, engine="native").interleaved)


def test_sharded_pack2_free_slots_hold_zeros():
    """5 chunks over 2 devices: the last round's second slot has no
    chunk and holds zeros of the chunks' shape and type."""
    pcm = tone_mix(20 * 256, 2, 16, seed=32)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=256))
    out, meta, _ = _same_sharded(data, n_dev=2, chunk_frames=4)
    assert meta["rounds"] == 3 and len(meta["num_frames"]) == 5
    free = out[2][1]
    assert free.shape == out[0][0].shape and free.dtype == out[0][0].dtype
    assert not free.any()


def test_sharded_pack2_unknown_total():
    """STREAMINFO total 0 rides the sharded path through the probe-scan
    frame estimate."""
    pcm = tone_mix(40 * 512, 2, 16, seed=33)
    data = encode(pcm, 44100, 16,
                  EncoderConfig(block_size=512, omit_total_samples=True))
    _, meta, _ = _same_sharded(data)
    assert sum(meta["num_frames"]) == 40


@pytest.mark.parametrize("total,cut", [(3072, True), (1024, True),
                                       (3000, False)])
def test_sharded_pack2_stop_cut(total, cut, corpus):
    """A fudged STREAMINFO total: frames that start at or after it
    drop (through apply_stop_cut), a frame that crosses it keeps
    everything; the JAX function's frames, block sizes and PCM."""
    data = corpus["lpc order 8"][0]
    full = sum(pshard.decode_to_device_sharded(
        data, _cpu_mesh(2), chunk_frames=2)[1]["num_frames"])
    _, meta, host = _same_sharded(with_total(data, total), n_dev=2,
                                  chunk_frames=2)
    if cut:
        assert len(host) == total * meta["channels"]
        assert sum(meta["num_frames"]) < full
    else:
        assert sum(meta["num_frames"]) == full


def test_sharded_to_host_empty_result():
    """No frames kept: an empty array of the container's dtype (the
    JAX function's fallback raises there)."""
    meta = {"channels": 2, "bits_per_sample": 24, "num_frames": [0],
            "block_sizes": [np.zeros(0, np.int32)]}
    rounds = [[torch.zeros((4, 128, 2), dtype=torch.int32)]]
    for pcm in (rounds, rounds[0], []):
        host = pshard.sharded_to_host(pcm, meta)
        assert host.shape == (0,) and host.dtype == np.int32


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_pack2_diverging_chunks(n_dev, corpus):
    """Single-frame chunks of 'constant heavy' diverge in their class
    sets: each slot is reconstructed in its own geometry, with no
    re-scan, and every round keeps one PCM shape [Fp, Bp, C]. The JAX
    function's PCM, the encoder's input and the completeness count."""
    from conftest import expected_output
    from zflac_tpu_torch.bitio import BitReader
    from zflac_tpu_torch.oracle import parse_metadata
    from zflac_tpu_torch.runtime import device as rt

    data, pcm, _sr, bps = corpus["constant heavy"]
    br = BitReader(data)
    cks = rt.stream_chunks(data, parse_metadata(br), br.pos // 8,
                           chunk_frames=1, fixed_fp=True)
    assert len({ck.spec_key() for ck in cks}) > 1
    out, meta, host = _same_sharded(data, n_dev=n_dev, chunk_frames=1)
    assert meta["rounds"] == -(-len(cks) // n_dev)
    for rnd in out:
        assert len({(tuple(t.shape), t.dtype) for t in rnd}) == 1
    np.testing.assert_array_equal(host, expected_output(pcm, bps))
    assert int(meta["psum_samples"]) == meta["channels"] * sum(
        int(b.sum()) for b in meta["block_sizes"])


def test_sharded_pack2_chunk_shapes_must_agree(monkeypatch, corpus):
    """Chunks of one call whose PCM shapes differ (here each scanned
    with its natural frame capacity, 4 and 2 frames) raise ValueError
    before anything is reconstructed."""
    real = pshard.stream_chunks

    def natural_fp(*args, **kw):
        return real(*args, **dict(kw, fixed_fp=False))

    monkeypatch.setattr(pshard, "stream_chunks", natural_fp)
    with pytest.raises(ValueError, match="PCM shapes diverge"):
        pshard.decode_to_device_sharded(corpus["lpc order 8"][0],
                                        _cpu_mesh(2), chunk_frames=4)


def test_stream_parameters_must_not_change(monkeypatch, corpus):
    """Chunks that disagree on the sample rate raise
    InconsistentParameters, as in the JAX function."""
    from zflac_tpu_torch.errors import InconsistentParameters
    from zflac_tpu_torch.runtime import device as rt

    real = rt.stream_chunks

    def second_chunk_resampled(*args, **kw):
        cks = real(*args, **kw)
        cks[1].sample_rate += 1
        return cks

    monkeypatch.setattr(pshard, "stream_chunks", second_chunk_resampled)
    with pytest.raises(InconsistentParameters):
        pshard.decode_to_device_sharded(corpus["lpc order 8"][0],
                                        _cpu_mesh(2), chunk_frames=2)
