"""The PyTorch port's rows-engine pieces (zflac_tpu_torch) against the
JAX package on the CPU: the plain versions of the lpc and lpc64 CUDA
kernels against the Pallas K6 kernel in interpret mode and the XLA scan
_lpc_scan (int32, and int64 under x64) over the whole shift range; the
flat rice16 layout against rice16_unpack_inline in interpret mode; the
sentinel-safe scatters and clamped gathers; the fixed-order
integration; the single-buffer Packer (int64 entries too);
reconstruct_packed on the same padded plan arrays as the JAX
reconstruct, staged in one buffer and uploaded in one copy for int32
and int64 plans alike; and, on streams whose frame count is not a power
of two, pad_plan's shapes (what the kernels need, not XLA's buckets)
and the rows engine's entry points against the JAX package's decode.
Tolerance zero: exact integer decodes. The same numpy inputs, made from
a seed, go to both packages. The CUDA kernels themselves are held to
these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.runtime.reconstruct import _lpc_scan  # noqa: E402

from zflac_tpu_torch.ops.lpc import (  # noqa: E402
    lpc_reconstruct,
    lpc_reconstruct_ref,
)
from zflac_tpu_torch.runtime import reconstruct as trec  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lpc_case(rng, S, B, *, coeff_bits=14, warm_bits=15, res_bits=15,
              bounded=False):
    """Orders 1..32, shifts 0..15 (10..15 when bounded), coefficients
    of `coeff_bits` bits in coeffs_rev's tail slots, warm-ups of
    `warm_bits` bits and residuals of `res_bits` bits, int64. With
    `bounded`, sum|c| <= 2^shift keeps the recurrence from growing, so
    large warm-ups stay large (the high-res cases)."""
    order = rng.integers(1, 33, S).astype(np.int32)
    shift = rng.integers(10 if bounded else 0, 16, S).astype(np.int32)
    coeffs_rev = np.zeros((S, 32), np.int32)
    rows = rng.integers(-(1 << (res_bits - 1)), 1 << (res_bits - 1),
                        (S, B)).astype(np.int64)
    lim = 1 << (warm_bits - 1)
    for s in range(S):
        o = order[s]
        cap = 1 << (coeff_bits - 1)
        if bounded:
            cap = max(1, min(cap, (1 << int(shift[s])) // int(o)))
        coeffs_rev[s, 32 - o:] = rng.integers(-cap, cap, o)
        rows[s, :o] = rng.integers(-lim, lim, o)
    return rows, coeffs_rev, shift, order


def _port_lpc(rows, coeffs_rev, shift, order):
    """The port's three forms on [S, B] numpy inputs: the kernel's plain
    version (time-major), its CPU wrapper, and lpc_scan. Returns the
    [S, B] numpy outputs."""
    args_t = (_t(rows.T), _t(coeffs_rev.T), _t(shift), _t(order))
    outs = [lpc_reconstruct_ref(*args_t).numpy().T,
            lpc_reconstruct(*args_t).numpy().T,
            trec.lpc_scan(_t(rows), _t(coeffs_rev), _t(shift),
                          _t(order)).numpy()]
    for o in outs:
        assert o.dtype == rows.dtype
    return outs


@pytest.mark.parametrize("S", [128, 200, 640])
def test_lpc_matches_jax(S):
    """lpc's plain version == the Pallas K6 kernel (interpret mode,
    hist 32) and _lpc_scan, int32 with wraparound (14-bit coefficients,
    orders 1-32). S = 200 is no multiple of the TPU's lane block: the
    port pads nothing."""
    from zflac_tpu.ops.lpc import lpc_reconstruct_tpu

    rng = np.random.default_rng(S)
    B = 96
    rows, coeffs_rev, shift, order = _lpc_case(rng, S, B)
    rows = rows.astype(np.int32)
    want = np.asarray(jax.jit(_lpc_scan)(
        jnp.asarray(rows), jnp.asarray(coeffs_rev), jnp.asarray(shift),
        jnp.asarray(order)))
    if S % 128 == 0:
        got_k = lpc_reconstruct_tpu(
            jnp.asarray(rows.T), jnp.asarray(coeffs_rev.T),
            jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]),
            lanes=128, hist=32, unroll=8, interpret=True)
        np.testing.assert_array_equal(np.asarray(got_k).T, want)
    for got in _port_lpc(rows, coeffs_rev, shift, order):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warm_bits", [24, 33])
def test_lpc64_matches_jax(warm_bits):
    """lpc64's plain version == _lpc_scan at int64 (under x64) on
    24-bit and 33-bit warm-ups with 15-bit coefficients: the sums pass
    2^32 by far."""
    rng = np.random.default_rng(warm_bits)
    S, B = 160, 200
    rows, coeffs_rev, shift, order = _lpc_case(
        rng, S, B, coeff_bits=15, warm_bits=warm_bits, res_bits=11,
        bounded=True)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(_lpc_scan)(
            jnp.asarray(rows), jnp.asarray(coeffs_rev),
            jnp.asarray(shift), jnp.asarray(order)))
    assert want.dtype == np.int64
    assert np.abs(want).max() >= 1 << (warm_bits - 2)
    for got in _port_lpc(rows, coeffs_rev, shift, order):
        np.testing.assert_array_equal(got, want)


# The scan writes the 5-bit shift field (indexer.cpp, read_bits(5):
# 0..31); the rest are amounts only a corrupt plan holds, where XLA's
# right_shift gives the sign fill (int32: >= 32; int64: >= 64; negative
# amounts read as unsigned).
_SHIFTS = np.array([0, 1, 2, 7, 15, 16, 30, 31, 32, 33, 40, 63, 64, 100,
                    -1, -32, 2**31 - 1, -2**31], np.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_lpc_shift_range_matches_jax(dtype):
    """Both instantiations' plain versions equal _lpc_scan for every
    amount the plan's field can carry and for out-of-range ones, on
    predictions of both signs (int64 runs under x64)."""
    rng = np.random.default_rng(11)
    S, B = len(_SHIFTS) * 8, 64
    rows, coeffs_rev, _, order = _lpc_case(
        rng, S, B, coeff_bits=15, warm_bits=33 if dtype == np.int64 else 16)
    rows = rows.astype(dtype)
    shift = np.repeat(_SHIFTS, 8)
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jax.jit(_lpc_scan)(
            jnp.asarray(rows), jnp.asarray(coeffs_rev),
            jnp.asarray(shift), jnp.asarray(order)))
    assert want.dtype == dtype
    for got in _port_lpc(rows, coeffs_rev, shift, order):
        np.testing.assert_array_equal(got, want)


# Lags a 32-lane group's coefficients reach, in turn (the histories the
# lpc and lpc64 kernels pick per warp), and the out-of-range shift
# amounts of _SHIFTS.
_GROUP_LAGS = (8, 16, 32)
_BAD_SHIFTS = _SHIFTS[8:]


@pytest.mark.parametrize("pattern", ["lags", "oldest", "shifts"])
@pytest.mark.parametrize("n", [1, 31, 33, 97])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_lpc_warp_patterns_match_jax(dtype, n, pattern):
    """lpc's and lpc64's plain versions == _lpc_scan (int64 under x64)
    on the inputs that drive the kernels' per-warp picks: lanes
    32g..32g+31 with coefficients up to lag 8, 16 and 32 in turn
    ('lags'); that, and the last lane's one nonzero coefficient at lag
    32, the oldest row ('oldest'); and the last group's lanes on the
    out-of-range shift amounts ('shifts')."""
    rng = np.random.default_rng(n * 10 + len(pattern))
    B = 64
    if dtype == np.int64:
        rows, coeffs_rev, shift, order = _lpc_case(
            rng, n, B, coeff_bits=15, warm_bits=33, res_bits=11,
            bounded=True)
    else:
        rows, coeffs_rev, shift, order = _lpc_case(rng, n, B)
    rows = rows.astype(dtype)
    lags = np.array([_GROUP_LAGS[s // 32 % 3] for s in range(n)])
    coeffs_rev = coeffs_rev * (np.arange(32)[None, :] >= 32 - lags[:, None])
    order = np.minimum(order, lags).astype(np.int32)
    if pattern == "oldest":
        coeffs_rev[-1] = 0
        coeffs_rev[-1, 0] = 5           # slot 0 multiplies s[t-32]
    if pattern == "shifts":
        g0 = (n - 1) // 32 * 32
        shift[g0:] = np.resize(_BAD_SHIFTS, n - g0)
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jax.jit(_lpc_scan)(
            jnp.asarray(rows), jnp.asarray(coeffs_rev.astype(np.int32)),
            jnp.asarray(shift), jnp.asarray(order)))
    assert want.dtype == dtype
    for got in _port_lpc(rows, coeffs_rev.astype(np.int32), shift, order):
        np.testing.assert_array_equal(got, want)


def test_lpc_strided_time_major_view():
    """The wrapper takes time-major rows with a row stride wider than
    the subframe count, as a slice of a wider array."""
    rng = np.random.default_rng(4)
    rows, coeffs_rev, shift, order = _lpc_case(rng, 384, 64)
    rows_t = _t(rows.T.astype(np.int32))
    sl = slice(128, 256)
    got = lpc_reconstruct(rows_t[:, sl], _t(coeffs_rev.T)[:, sl],
                          _t(shift[sl]), _t(order[sl]))
    want = lpc_reconstruct_ref(rows_t[:, sl].contiguous(),
                               _t(coeffs_rev.T)[:, sl].contiguous(),
                               _t(shift[sl]), _t(order[sl]))
    assert torch.equal(got, want)


@pytest.mark.skipif(not native_available(), reason="needs native")
def test_rice16_flat_matches_jax():
    """rice16's flat layout == rice16_unpack_inline in interpret mode on
    a real chunk, == the rows layout at Ssort = NG, and relaid by p-rows
    == the rows layout at the chunk's Ssort (the two layouts
    coincide)."""
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.encoder import EncoderConfig, encode
    from zflac_tpu.index.native_indexer import pack2_range
    from zflac_tpu.oracle import parse_metadata
    from zflac_tpu.ops.rice16 import rice16_unpack_inline
    from zflac_tpu.testing import correlated_stereo
    from zflac_tpu_torch.ops.rice16 import (G2, rice16_unpack,
                                            rice16_unpack_ref,
                                            rice16_unpack_rows_ref)

    pcm = correlated_stereo(16384, 16, seed=11)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=2048))
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info)
    assert ck is not None
    W, NG, Ssort = ck.W, ck.NGp, ck.Ssort
    win = ck.buf[ck.off["win"]:ck.off["win"] + W * NG].reshape(W, NG)
    meta = ck.buf[ck.off["meta"]:ck.off["meta"] + NG]
    want = np.asarray(rice16_unpack_inline(
        jnp.asarray(win.view(np.uint32)), jnp.asarray(meta[None, :]),
        lanes=NG, interpret=True))
    assert want.shape == (G2, NG) and np.abs(want).max() > 0
    win_t, meta_t = _t(win), _t(meta)
    flat = rice16_unpack_ref(win_t, meta_t)
    np.testing.assert_array_equal(flat.numpy(), want)
    np.testing.assert_array_equal(rice16_unpack(win_t, meta_t).numpy(),
                                  want)
    assert torch.equal(rice16_unpack_rows_ref(win_t, meta_t, Ssort=NG),
                       flat)
    GP1 = NG // Ssort
    assert GP1 > 1
    relaid = flat.view(G2, GP1, Ssort).transpose(0, 1).reshape(-1, Ssort)
    assert torch.equal(
        rice16_unpack_rows_ref(win_t, meta_t, Ssort=Ssort), relaid)


def test_scatter_rows_sentinel_geometry():
    """The [2, 256] canvas with 128 update rows, 126 of them sentinels
    (the geometry XLA:CPU once miscompiled): the sentinel updates are
    discarded, as the JAX scatter_rows discards them; likewise
    scatter_flat."""
    from zflac_tpu.runtime import scatter as jsc
    from zflac_tpu_torch.runtime.scatter import scatter_flat, scatter_rows

    idx = np.array([0, 1] + [2] * 126, np.int32)       # sentinel Sp == 2
    upd = np.tile(np.arange(128, dtype=np.int32)[:, None] + 100, (1, 256))
    want = np.asarray(jax.jit(jsc.scatter_rows)(
        jnp.zeros((2, 256), jnp.int32), jnp.asarray(idx), jnp.asarray(upd)))
    got = scatter_rows(torch.zeros((2, 256), dtype=torch.int32), _t(idx),
                       _t(upd))
    assert got.shape == (2, 256)
    assert got[0, 0] == 100 and got[1, 0] == 101
    np.testing.assert_array_equal(got.numpy(), want)

    fidx = np.array([3, 512, 512, 600], np.int32)
    fval = np.array([7, 8, 9, 10], np.int32)
    want = np.asarray(jax.jit(jsc.scatter_flat)(
        jnp.zeros((512,), jnp.int32), jnp.asarray(fidx), jnp.asarray(fval)))
    got = scatter_flat(torch.zeros(512, dtype=torch.int32), _t(fidx),
                       _t(fval))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 7 and int(got.sum()) == 7


def test_gather_rows_clamps_as_xla():
    """gather_rows reads an out-of-range index as XLA's gather does
    (clamped to the last row), where torch indexing would raise."""
    from zflac_tpu_torch.runtime.scatter import gather_rows

    a = np.arange(5 * 3, dtype=np.int32).reshape(5, 3)
    idx = np.array([0, 4, 5, 9, 2, -1], np.int32)
    want = np.asarray(jnp.asarray(a)[jnp.asarray(idx)])
    np.testing.assert_array_equal(gather_rows(_t(a), _t(idx)).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_fixed_integrate_matches_jax(dtype):
    """fixed_integrate (subframe-major) == _fixed_integrate for mixed
    orders 0-4, with wraparound at int32 and 33-bit values at int64."""
    from zflac_tpu.runtime.reconstruct import _fixed_integrate

    rng = np.random.default_rng(8)
    n, B = 64, 384
    top = 1 << (32 if dtype == np.int64 else 30)
    rows = rng.integers(-top, top, (n, B)).astype(dtype)
    order = rng.integers(0, 5, n).astype(np.int32)
    seeds = rng.integers(-top, top, (n, 4)).astype(dtype)
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jax.jit(_fixed_integrate)(
            jnp.asarray(rows), jnp.asarray(order), jnp.asarray(seeds)))
    assert want.dtype == dtype
    got = trec.fixed_integrate(_t(rows), _t(order), _t(seeds))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packer_round_trip_matches_jax():
    """The port's Packer emits the JAX Packer's buffer and spec, and its
    unpack gives the JAX unpack's arrays (uint32 entries as uint32)."""
    from zflac_tpu.runtime import pack as jpack
    from zflac_tpu_torch.runtime.pack import Packer, unpack

    rng = np.random.default_rng(6)
    arrays = {"rows": rng.integers(-9, 9, (16, 128)).astype(np.int32),
              "kind": rng.integers(0, 4, 16).astype(np.int32),
              "win": rng.integers(0, 1 << 32, (3, 5), dtype=np.uint32),
              "ci_lpc": np.array([1, 3, 16, 16], np.int32)}
    packers = Packer(), jpack.Packer()
    for p in packers:
        for k, v in arrays.items():
            p.add(k, v)
    (buf, spec), (jbuf, jspec) = (p.finish() for p in packers)
    assert spec == jspec
    np.testing.assert_array_equal(buf, jbuf)
    got = unpack(_t(buf), spec)
    want = jax.jit(lambda b: jpack.unpack(b, jspec))(jnp.asarray(jbuf))
    for k, v in arrays.items():
        assert got[k].dtype == (torch.uint32 if v.dtype == np.uint32
                                else torch.int32)
        g = got[k].view(torch.int32).numpy().view(v.dtype)
        np.testing.assert_array_equal(g, np.asarray(want[k]))
        np.testing.assert_array_equal(g, v)


@pytest.mark.parametrize("first", ["int32", "uint32"])
def test_packer_int64_entries(first):
    """An int64 array goes into the Packer as int32 word pairs at an
    even word offset (one pad word after an odd-sized entry), tagged
    "l", and unpack views it as int64 with its values; the int32 and
    uint32 entries before it keep the JAX Packer's buffer and spec."""
    from zflac_tpu.runtime import pack as jpack
    from zflac_tpu_torch.runtime.pack import Packer, unpack

    rng = np.random.default_rng(7)
    head = {"order": rng.integers(0, 33, 5).astype(np.int32)}
    if first == "uint32":
        head = {"win": rng.integers(0, 1 << 32, 5, dtype=np.uint32)}
    rows = rng.integers(-(1 << 40), 1 << 40, (3, 8), dtype=np.int64)
    tail = np.array([1, 2, 3], np.int32)
    p, jp = Packer(), jpack.Packer()
    for k, v in head.items():
        p.add(k, v)
        jp.add(k, v)
    p.add("rows", rows)
    p.add("ci_lpc", tail)
    buf, spec = p.finish()
    jbuf, jspec = jp.finish()
    assert spec[:1] == jspec
    np.testing.assert_array_equal(buf[:5], jbuf)
    (_, o_rows, shape, tag), (_, o_tail, _, _) = spec[1:]
    assert (o_rows, shape, tag) == (6, (3, 8), "l") and o_tail == 6 + 48
    assert len(buf) == 6 + 48 + 3
    got = unpack(_t(buf), spec)
    assert got["rows"].dtype == torch.int64
    np.testing.assert_array_equal(got["rows"].numpy(), rows)
    np.testing.assert_array_equal(got["ci_lpc"].numpy(), tail)
    # rows first, as stage_plan packs them: offset 0, no pad word.
    p = Packer()
    p.add("rows", rows)
    buf, spec = p.finish()
    assert spec == (("rows", 0, (3, 8), "l"),) and len(buf) == 48


# Streams made here beside the corpus's: 36 frames of stereo LPC, whose
# class list of 72 entries is padded to 96, a multiple of 32 that is not
# a power of two.
_STREAMS = {"36 frames": (36 * 256, 256)}


def _data(corpus, name):
    if name in _STREAMS:
        from zflac_tpu.encoder import EncoderConfig, encode
        from zflac_tpu.testing import correlated_stereo
        n, block = _STREAMS[name]
        return encode(correlated_stereo(n, 16, seed=21), 44100, 16,
                      EncoderConfig(block_size=block))
    return corpus[name][0]


def _plan(corpus, name, safe_lpc=False):
    from zflac_tpu.index import build_plan
    plan = build_plan(_data(corpus, name))
    if safe_lpc:
        plan.wide = plan.kind == 3
    return plan


def _kw(plan):
    from zflac_tpu import format as fmt
    return dict(num_channels=plan.channels,
                container_bits=fmt.container_bits(plan.info.bits_per_sample),
                do_decorrelate=bool(
                    np.any(plan.channel_code > fmt.CH_INDEPENDENT_MAX)))


_ORDER = ("rows", "kind", "order", "wasted", "shift", "coeffs", "seeds")


def _jax_args(plan, arrays):
    """The JAX core's plan arguments in _ORDER: pad_plan's arrays, and
    the plan's kind and fixed seeds, which the port's core does not
    take."""
    return [{"kind": plan.kind, "seeds": plan.fixed_seeds}.get(k)
            if k in ("kind", "seeds") else arrays[k] for k in _ORDER]


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("name,safe_lpc,pad", [
    ("lpc order 8", False, 1),                 # 16-bit: the lpc kernel
    ("bps 24", False, 1),                      # int64 stream: lpc64
    ("hi-res 32bit mid_side", False, 1),       # 33-bit side channels
    ("lpc order 32", True, 1),                 # safe_lpc: lpc_wide
    ("fixed order 2", False, 4),               # classes padded 4x
    ("constant heavy", False, 8),
    ("36 frames", False, 1),                   # lpc list 72 -> 96
])
def test_reconstruct_matches_jax(name, safe_lpc, pad, corpus):
    """The port's reconstruct on the same padded plan arrays (pad_plan,
    packed in one buffer by stage_arrays, int64 rows as word pairs, and
    run by launch_plan) == the JAX reconstruct (scan LPC, under x64 for
    int64 rows or a wide class), with class lists padded with sentinels
    to `pad` times their length, a multiple of 32 (gathers and scatters
    of more sentinels than members)."""
    from zflac_tpu.runtime import reconstruct as jrec
    from zflac_tpu_torch.runtime.decode import (launch_plan, pad_plan,
                                                stage_arrays)

    plan = _plan(corpus, name, safe_lpc)
    arrays, class_idx = pad_plan(plan)
    S = arrays["rows"].shape[0]
    assert all(len(v) % 32 == 0 for v in class_idx.values())
    if name in _STREAMS:  # padded to 32, not to a power of two
        assert len(class_idx["lpc"]) == 96
    class_idx = {k: np.concatenate([v, np.full(len(v) * (pad - 1), S,
                                               np.int32)])
                 for k, v in class_idx.items()}
    if safe_lpc:
        assert set(class_idx) >= {"lpc_wide"} and "lpc" not in class_idx
    x64 = arrays["rows"].dtype == np.int64 or bool(np.any(plan.wide))
    with jax.enable_x64(x64):
        want = np.asarray(jrec.reconstruct(
            *(jnp.asarray(a) for a in _jax_args(plan, arrays)),
            {k: jnp.asarray(v) for k, v in class_idx.items()},
            jnp.asarray(arrays["channel_code"]), **_kw(plan)))
    staged = stage_arrays(arrays, class_idx, _kw(plan))
    assert staged.spec[0][:2] == ("rows", 0)
    got = launch_plan(staged, "cpu")
    assert got.dtype == getattr(torch, want.dtype.name)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("name,safe_lpc", [
    ("lpc order 8", False),                    # int32 rows
    ("bps 24", False),                         # int64 rows: lpc64
    ("hi-res 32bit mid_side", False),          # int64, 33-bit sides
    ("lpc order 32", True),                    # safe_lpc: lpc_wide
])
def test_launch_plan_uploads_one_buffer(name, safe_lpc, corpus,
                                        monkeypatch):
    """stage_plan -> launch_plan on the CPU makes exactly one
    host-to-device copy (device.upload) for an int32 plan and for an
    int64 one, the packed buffer, which holds neither the plan's kind
    nor its fixed seeds; its PCM equals the JAX reconstruct's."""
    from zflac_tpu.runtime import reconstruct as jrec
    from zflac_tpu_torch.runtime import decode as rd

    plan = _plan(corpus, name, safe_lpc)
    uploads = []
    real = rd.upload

    def counted(host, device):
        uploads.append(host)
        return real(host, device)

    monkeypatch.setattr(rd, "upload", counted)
    staged = rd.stage_plan(plan)
    assert {n for n, *_ in staged.spec} == {
        *rd.PLAN_ARRAYS, *("ci_" + c for c in staged.class_names)}
    tags = {n: tag for n, _, _, tag in staged.spec}
    assert tags["rows"] == ("l" if plan.rows.dtype == np.int64 else "i")
    got = rd.launch_plan(staged, "cpu")
    assert len(uploads) == 1 and uploads[0] is staged.buf
    arrays, class_idx = rd.pad_plan(plan)
    x64 = plan.rows.dtype == np.int64 or safe_lpc
    with jax.enable_x64(x64):
        want = np.asarray(jrec.reconstruct(
            *(jnp.asarray(a) for a in _jax_args(plan, arrays)),
            {k: jnp.asarray(v) for k, v in class_idx.items()},
            jnp.asarray(arrays["channel_code"]), **_kw(plan)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_reconstruct_sharded_uploads_once_a_device(n_dev, bps,
                                                   monkeypatch):
    """reconstruct_sharded stages each device's slice of shard_plan in
    one packed buffer (shard.local_plan; int64 rows at 24 bits) and
    uploads it in one copy a device; its PCM equals the single-device
    reconstruction's."""
    from zflac_tpu_torch.encoder import EncoderConfig, encode
    from zflac_tpu_torch.index import build_plan_py
    from zflac_tpu_torch.parallel import reconstruct_sharded
    from zflac_tpu_torch.runtime import decode as rd
    from zflac_tpu_torch.testing import tone_mix

    pcm = tone_mix(9 * 512, 2, bps, seed=9)
    plan = build_plan_py(encode(pcm, 44100, bps,
                                EncoderConfig(block_size=512)))
    want = rd._run_reconstruct(plan, "cpu")
    uploads = []
    real = rd.upload

    def counted(host, device):
        uploads.append(host)
        return real(host, device)

    monkeypatch.setattr(rd, "upload", counted)
    got, total = reconstruct_sharded(plan, ["cpu"] * n_dev)
    assert len(uploads) == n_dev
    assert all(u.dtype == np.int32 and u.ndim == 1 for u in uploads)
    assert total == -(-9 // n_dev) * n_dev * 512
    np.testing.assert_array_equal(got, want[:, :512])


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("name", ["lpc order 8", "stereo mid_side",
                                  "channels 5"])
def test_reconstruct_packed_matches_jax(name, corpus):
    """reconstruct_packed on the port's packed buffer == the JAX
    reconstruct_packed on the JAX Packer's buffer (the same bytes)."""
    from zflac_tpu.runtime import pack as jpack
    from zflac_tpu.runtime import reconstruct as jrec
    from zflac_tpu_torch.runtime.decode import pad_plan
    from zflac_tpu_torch.runtime.pack import Packer

    plan = _plan(corpus, name)
    arrays, class_idx = pad_plan(plan)
    assert arrays["rows"].dtype == np.int32
    bufs = []
    jarrays = dict(zip(_ORDER, _jax_args(plan, arrays)))
    for p in (Packer(), jpack.Packer()):
        for k in (*_ORDER, "channel_code"):
            p.add(k, jarrays.get(k, arrays.get(k)))
        for k, v in class_idx.items():
            p.add("ci_" + k, v)
        bufs.append(p.finish())
    (buf, spec), (jbuf, jspec) = bufs
    assert spec == jspec
    np.testing.assert_array_equal(buf, jbuf)
    names = tuple(sorted(class_idx))
    want = np.asarray(jrec.reconstruct_packed(
        jnp.asarray(jbuf), spec=jspec, class_names=names, **_kw(plan)))
    got = trec.reconstruct_packed(_t(buf), spec=spec, class_names=names,
                                  **_kw(plan))
    np.testing.assert_array_equal(got.numpy(), want)


# Corpus streams whose frame count is not a power of two (3, 5, 6 or 7
# frames): int32 and int64 rows, fixed and LPC classes, 1 to 8 channels,
# a block of 1021 samples (not a multiple of 8), 33-bit side channels,
# variable blocking and an unknown total.
_ODD_FRAMES = ("lpc order 8", "fixed order 2", "bps 24",
               "uncommon blocksize", "channels 5", "surround 8ch 24bit",
               "hi-res 24/96", "hi-res 32bit left_side", "unknown length",
               "variable blocksize")


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("name", _ODD_FRAMES)
def test_pad_plan_pads_only_what_the_kernels_need(name, corpus):
    """pad_plan's shapes: rows (S, B rounded up to 8) with zero columns
    past B, the per-subframe arrays at S and channel_code at F (no
    power-of-two frame axis), and each class list ceil32 long, its tail
    only the sentinel S."""
    from zflac_tpu_torch.index import build_plan
    from zflac_tpu_torch.runtime.decode import PLAN_ARRAYS, pad_plan

    plan = build_plan(corpus[name][0])
    F, S, B = plan.num_frames, plan.num_subframes, plan.max_block
    assert F & (F - 1), F
    arrays, class_idx = pad_plan(plan)
    assert arrays["rows"].shape == (S, -(-B // 8) * 8)
    np.testing.assert_array_equal(arrays["rows"][:, :B], plan.rows)
    assert not arrays["rows"][:, B:].any()
    # Only what the card reads: no kind, no fixed seeds.
    assert set(arrays) == set(PLAN_ARRAYS)
    for k in ("order", "wasted", "shift"):
        assert arrays[k].shape == (S,), k
    assert arrays["coeffs"].shape == (S, 32)
    assert arrays["channel_code"].shape == (F,)
    classes = {k: v for k, v in plan.classes().items() if len(v)}
    assert set(class_idx) == set(classes)
    for k, idx in classes.items():
        got = class_idx[k]
        assert got.dtype == np.int32 and len(got) == -(-len(idx) // 32) * 32
        np.testing.assert_array_equal(got[:len(idx)], idx)
        assert (got[len(idx):] == S).all(), k


_JAX_PCM = {}


def _rows_entry(entry, data):
    import zflac_tpu_torch as zt
    if entry == "decode":
        return zt.decode(data, device="cpu").interleaved
    if entry == "decode_pipelined":
        return zt.decode_pipelined(data, chunk_frames=3,
                                   device="cpu").interleaved
    return np.concatenate(list(zt.stream_decode(data, chunk_frames=3,
                                                device="cpu")))


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("entry", ["decode", "decode_pipelined",
                                   "stream_decode"])
@pytest.mark.parametrize("name", _ODD_FRAMES)
def test_rows_entry_points_at_kernel_shapes(name, entry, corpus):
    """decode, decode_pipelined(chunk_frames=3) and stream_decode on the
    CPU, through pad_plan's shapes, == the JAX package's decode."""
    import zflac_tpu

    data = corpus[name][0]
    if name not in _JAX_PCM:
        _JAX_PCM[name] = zflac_tpu.decode(data).interleaved
    want = _JAX_PCM[name]
    got = _rows_entry(entry, data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
