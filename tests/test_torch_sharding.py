"""The PyTorch port's multi-device sharding (zflac_tpu_torch.parallel.
shard) against the JAX package's (zflac_tpu.parallel.shard) on the CPU,
on the same inputs: shard_plan's meta and arrays, in the rows engine's
kernel shapes, against the JAX function's; reconstruct_sharded (the
cases of tests/test_sharding.py); decode_to_device_sharded with
sharded_to_host (the cases of tests/test_sharding_pack2.py and a
192-sample block, on meshes of 1, 2, 4 and 8, a stream whose
STREAMINFO total forces the stop cut, chunks whose class sets diverge,
a short last round, and an empty result), where each port chunk keeps
its own card geometry [F_i, Bp, C] and holds the JAX slot's frames and
columns. The port runs on a list of CPU devices, the JAX package on
its virtual 8-device CPU mesh. Tolerance zero."""

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
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.index import build_plan_py  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.parallel import make_mesh, reconstruct_sharded  # noqa: E402
from zflac_tpu_torch.parallel import shard as pshard  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402
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


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [8, 13, "4ch 24bit", "odd block"])
def test_shard_plan_matches_jax(n_dev, case):
    """shard_plan against the JAX function: the same meta and the same
    per-subframe arrays; rows [D, S_loc, B8] holding the JAX rows in
    [:, :, :B] and zeros after; every class list the same members per
    device, sentinel-padded to a multiple of 32 (the rows engine's
    pad_plan shapes) where the JAX function pads to a power of two."""
    if case == "4ch 24bit":
        data = _stream_4ch_24bit()
    elif case == "odd block":
        pcm = correlated_stereo(5 * 725, 16, seed=3)
        data = encode(pcm, 44100, 16, EncoderConfig(block_size=725))
    else:
        data = _stream(case)
    arrays, meta = pshard.shard_plan(build_plan_py(data), n_dev)
    jarrays, jmeta = jshard.shard_plan(jbuild_plan_py(data), n_dev)
    assert meta == jmeta and list(arrays) == list(jarrays)
    B, S_loc = meta["B"], meta["F_loc"] * meta["C"]
    rows = arrays["rows"]
    assert rows.shape == (n_dev, S_loc, -(-B // 8) * 8)
    assert rows.dtype == jarrays["rows"].dtype
    np.testing.assert_array_equal(rows[:, :, :B], jarrays["rows"])
    assert not rows[:, :, B:].any()
    for name, a in arrays.items():
        assert a.dtype == jarrays[name].dtype, name
        if name == "rows":
            continue
        if name not in pshard._SHARD_CLASSES:
            np.testing.assert_array_equal(a, jarrays[name], err_msg=name)
            continue
        assert a.shape[0] == n_dev and a.shape[1] % 32 == 0, name
        for d in range(n_dev):
            members = a[d][a[d] < S_loc]
            np.testing.assert_array_equal(
                members, jarrays[name][d][jarrays[name][d] < S_loc],
                err_msg=f"{name} device {d}")
            assert (a[d][len(members):] == S_loc).all()
        most = max(int((a[d] < S_loc).sum()) for d in range(n_dev))
        assert a.shape[1] == -(-most // 32) * 32, name


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


# Exact corpus keys, the cases of tests/test_sharding_pack2.py and a
# 192-sample block (Bp 192 here, 256 in the JAX function's slots). A
# name miss is a FAILURE, not a skip.
_CASES = ["lpc order 8", "fixed order 2", "stereo mid_side",
          "stereo left_side", "stereo side_right", "wasted bits",
          "blocksize 1000", "blocksize 16", "escaped partitions",
          "lpc order 32", "hi-res 24/96", "surround 8ch 24bit",
          "partition order 8", "variable blocksize",
          "hi-res 32bit", "hi-res 32bit mid_side",
          "hi-res 32bit left_side", "blocksize 192"]


def _call_chunks(data, n_dev, chunk_frames=0):
    """The chunks a decode_to_device_sharded call over n_dev slots
    reconstructs: the same scan at the same chunk size, in the card
    layout."""
    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    if chunk_frames <= 0:
        chunk_frames = pshard.sharded_chunk_frames(data, pos, info, n_dev)
    return info, rt.stream_chunks(data, info, pos,
                                  chunk_frames=chunk_frames)


def _same_sharded(data, n_dev=8, **kw):
    """decode_to_device_sharded + sharded_to_host equal the JAX pair:
    PCM, frames, block sizes, rounds and the sample count. Each port
    tensor is its chunk's own card geometry (F_i, Bp, C), with Bp the
    stream's largest block rounded up to 8 (at least 16), no frame past
    the chunk's F_i, and its first F_i frames and first B columns (B
    the stream's largest block) equal to the JAX slot's; every round
    but the last holds n_dev tensors. Returns the port's (rounds, meta,
    host PCM)."""
    mesh = _cpu_mesh(n_dev)
    r = pshard.decode_to_device_sharded(data, mesh, **kw)
    jr = jshard.decode_to_device_sharded(data, _jax_mesh(n_dev), **kw)
    assert r is not None and jr is not None, "declined an admissible stream"
    (out, meta), (jout, jmeta) = r, jr
    assert isinstance(out, list) and len(out) == meta["rounds"]
    info, cks = _call_chunks(data, n_dev, kw.get("chunk_frames", 0))
    assert [len(rnd) for rnd in out] == [
        min(n_dev, len(cks) - i) for i in range(0, len(cks), n_dev)]
    Bp = -(-max(info.max_block_size, 16) // 8) * 8
    B = info.max_block_size
    for i, ck in enumerate(cks):
        t, jslot = out[i // n_dev][i % n_dev], jout[i // n_dev][i % n_dev]
        assert tuple(t.shape) == (ck.F, Bp, ck.C) == (ck.Fp, ck.Bp, ck.C)
        assert t.device == mesh[i % n_dev]
        assert t.dtype == getattr(torch, jslot.dtype.name)
        np.testing.assert_array_equal(t[:, :B].numpy(),
                                      np.asarray(jslot)[:ck.F, :B])
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


def _sharded_case(name, corpus, n_dev=8):
    assert name in corpus, (
        f"corpus case {name!r} missing: fix the name, don't skip")
    data = corpus[name][0]
    _kernels.launches.clear()
    _out, meta, host = _same_sharded(data, n_dev=n_dev)
    assert sum(_kernels.launches.values()) == 0     # the CPU route
    ref = zflac_tpu.decode(data, engine="native")
    shift = fmt.normalization_shift(meta["bits_per_sample"])
    np.testing.assert_array_equal(
        host, ref.interleaved >> shift if shift else ref.interleaved)
    # bssub counts per subframe, i.e. samples x channels.
    assert int(meta["psum_samples"]) == meta["channels"] * sum(
        int(b.sum()) for b in meta["block_sizes"])


@pytest.mark.parametrize("name", _CASES)
def test_sharded_pack2_matches_jax(name, corpus):
    _sharded_case(name, corpus)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("name", _CASES)
def test_sharded_pack2_small_meshes_match_jax(name, n_dev, corpus):
    """The same cases on meshes of 1, 2 and 4: more frames a chunk, a
    short last round or a single one."""
    _sharded_case(name, corpus, n_dev)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_pack2_pcm_bytes_equal_decode_to_device(n_dev, corpus):
    """With the chunks in their own frames, a sharded call holds
    decode_to_device's chunks at the same chunk size, tensor for tensor,
    and so its PCM bytes (the slot shape would pad every chunk to the
    call's chunk size)."""
    data = corpus["lpc order 8"][0]
    out, meta = pshard.decode_to_device_sharded(data, _cpu_mesh(n_dev),
                                                chunk_frames=2)
    dd = rt.decode_to_device(data, device="cpu", chunk_frames=2)
    assert meta["num_frames"] == dd.num_frames and len(dd.chunks) > 1
    flat = [t for rnd in out for t in rnd]
    assert len(flat) == len(dd.chunks)
    for t, want in zip(flat, dd.chunks):
        assert torch.equal(t, want)


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


def test_sharded_pack2_last_round_holds_only_its_chunks():
    """5 chunks over 2 devices: the last round has no free slot to fill
    (the JAX function's holds zeros there). It holds only its one chunk,
    on the first device, and sharded_to_host is bit-exact."""
    pcm = tone_mix(20 * 256, 2, 16, seed=32)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=256))
    out, meta, host = _same_sharded(data, n_dev=2, chunk_frames=4)
    assert meta["rounds"] == 3 and len(meta["num_frames"]) == 5
    assert [len(rnd) for rnd in out] == [2, 2, 1]
    assert tuple(out[2][0].shape) == (4, 256, 2)
    np.testing.assert_array_equal(
        host, zflac_tpu.decode(data, engine="native").interleaved)


def test_sharded_pack2_short_only_round():
    """3 chunks over 4 devices: the only round holds 3 tensors, and
    sharded_to_host reads each chunk from it."""
    pcm = tone_mix(12 * 256, 2, 16, seed=34)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=256))
    out, meta, host = _same_sharded(data, n_dev=4, chunk_frames=4)
    assert meta["rounds"] == 1 and [len(r) for r in out] == [3]
    np.testing.assert_array_equal(
        host, zflac_tpu.decode(data, engine="native").interleaved)
    np.testing.assert_array_equal(pshard.sharded_to_host(out[0], meta),
                                  host)


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
    re-scan and no common shape a round. The JAX function's PCM, the
    encoder's input and the completeness count."""
    from conftest import expected_output

    data, pcm, _sr, bps = corpus["constant heavy"]
    _, cks = _call_chunks(data, n_dev, chunk_frames=1)
    assert len({ck.spec_key() for ck in cks}) > 1
    out, meta, host = _same_sharded(data, n_dev=n_dev, chunk_frames=1)
    assert meta["rounds"] == -(-len(cks) // n_dev)
    np.testing.assert_array_equal(host, expected_output(pcm, bps))
    assert int(meta["psum_samples"]) == meta["channels"] * sum(
        int(b.sum()) for b in meta["block_sizes"])


def test_sharded_pack2_chunks_keep_their_own_shapes(corpus):
    """Chunks of one call need not agree on their shapes: 'variable
    blocksize' in 4-frame chunks over 2 devices gives chunks of
    different F in one round, and each is reconstructed in its own
    shape, bit-exact against the JAX function."""
    data = corpus["variable blocksize"][0]
    out, meta, _ = _same_sharded(data, n_dev=2, chunk_frames=4)
    frames = [t.shape[0] for rnd in out for t in rnd]
    assert len(set(frames)) > 1
    assert any(len({t.shape for t in rnd}) > 1 for rnd in out)


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
