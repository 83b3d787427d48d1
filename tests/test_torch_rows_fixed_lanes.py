"""The rows engine's fixed class as lanes of the lpc kernel
(zflac_tpu_torch/runtime/reconstruct.py lpc_lanes_inputs,
reconstruct_core), on the CPU, where lpc and lpc64 run their plain
version (lpc_reconstruct_ref): fixed lanes of orders 0-4 beside LPC
lanes, or alone, equal fixed_integrate (the seeded cumsums, which
tests/test_torch_rows_ops.py ties to the JAX package) and the samples
they code, bit for bit, in int32 with wrapping sums and in int64 with
33-bit values; reconstruct_core equals the JAX package's rows engine on
plans with and without an lpc class, with an lpc_wide class, wasted
bits, all four stereo channel codes, a short last block and
sentinel-padded class lists, with no torch.cumsum called and one lpc
launch for the fixed and lpc classes; decode returns the input PCM on
encoded streams and counts `fixed_lanes` and `fixed_own_launches`; and
reconstruct_sharded's per-device body runs a shard that holds fixed
lanes and no LPC lanes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu.index import build_plan_py as jbuild_plan_py  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.parallel import shard as jshard  # noqa: E402
from zflac_tpu.runtime import reconstruct as jrec  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import format as fmt  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import build_plan, build_plan_py  # noqa: E402
from zflac_tpu_torch.parallel import make_mesh, reconstruct_sharded  # noqa: E402
from zflac_tpu_torch.parallel import shard as pshard  # noqa: E402
from zflac_tpu_torch.runtime import reconstruct as trec  # noqa: E402
from zflac_tpu_torch.runtime.decode import (  # noqa: E402
    PLAN_ARRAYS,
    launch_plan,
    pad_plan,
    stage_arrays,
    stage_plan,
)
from zflac_tpu_torch.testing import tone_mix, wasted_bits_signal  # noqa: E402
from zflac_tpu_torch.utils.timer import recording  # noqa: E402

_ORDER = ("rows", "kind", "order", "wasted", "shift", "coeffs", "seeds")
_TRIANGLE = np.array([[1, 0, 0, 0], [-1, 1, 0, 0], [1, -2, 1, 0],
                      [-1, 3, -3, 1]], dtype=np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _core(arrays, class_idx, kw):
    """reconstruct_core on the CPU as the rows engine runs it: the
    arrays and class lists packed in one buffer, uploaded, unpacked."""
    return launch_plan(stage_arrays(
        {k: arrays[k] for k in PLAN_ARRAYS}, class_idx, kw), "cpu")


@pytest.fixture
def launches(monkeypatch):
    """A spy on the core's lpc_reconstruct: the returned list collects
    each call's (rows dtype, lanes)."""
    calls = []
    real = trec.lpc_reconstruct

    def spy(*args):
        calls.append((args[0].dtype, args[0].shape[1]))
        return real(*args)

    monkeypatch.setattr(trec, "lpc_reconstruct", spy)
    return calls


@pytest.fixture
def no_cumsum(monkeypatch):
    """Any torch.cumsum, function or method, raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cumsum called")

    monkeypatch.setattr(torch, "cumsum", refuse)
    monkeypatch.setattr(torch.Tensor, "cumsum", refuse)


def _fixed_rows(rng, orders, B: int, bits: int, dtype):
    """Fixed-predictor subframes of `orders` [n]: random samples [n, B]
    of `bits` bits, the rows as the indexers leave them (raw warm-ups at
    t < order, the order-th differences after) and the finite-difference
    seeds [n, 4] (plan.py SEED_TRIANGLE, zero past the order), all
    wrapped to `dtype`."""
    n = len(orders)
    samples = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (n, B),
                           dtype=np.int64)
    rows = samples.copy()
    for k in range(1, 5):
        sel = orders == k
        rows[sel, k:] = np.diff(samples[sel], n=k, axis=1)
    seeds = samples[:, :4] @ _TRIANGLE.T
    seeds[np.arange(4)[None, :] >= orders[:, None]] = 0
    return samples.astype(dtype), rows.astype(dtype), seeds.astype(dtype)


def _padded(members, S: int, pad: int = 1):
    """A class's gather list as pad_plan pads it (the sentinel S up to a
    multiple of 32), then `pad` times as long."""
    n = -(-len(members) // 32) * 32 * pad
    out = np.full(n, S, dtype=np.int32)
    out[:len(members)] = members
    return out


_LANE_FORMS = {"int32 wrapping": (np.int32, 32),
               "int64 33-bit": (np.int64, 33)}


@pytest.mark.parametrize("with_lpc", [True, False],
                         ids=["shared launch", "own launch"])
@pytest.mark.parametrize("orders", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("form", list(_LANE_FORMS))
def test_fixed_lanes_match_fixed_integrate(form, orders, with_lpc, launches):
    """lpc_lanes_inputs' launch over the fixed class's padded list
    (followed by the lpc class's where there is one) gives each fixed
    lane the table's coefficients, reversed, and its shift 0; through
    lpc_reconstruct its lanes equal the samples and fixed_integrate with
    the seeds, bit for bit, and the LPC lanes equal lpc_scan."""
    dtype, bits = _LANE_FORMS[form]
    rng = np.random.default_rng(
        (list(_LANE_FORMS).index(form), 5 if orders == "mixed" else orders,
         with_lpc))
    S, B, n_fixed = 64, 64, 40
    perm = rng.permutation(S)
    fixed, lpc = np.sort(perm[:n_fixed]), np.sort(perm[n_fixed:])
    f_order = (rng.integers(0, 5, n_fixed) if orders == "mixed"
               else np.full(n_fixed, orders)).astype(np.int32)
    samples, f_rows, f_seeds = _fixed_rows(rng, f_order, B, bits, dtype)

    rows = rng.integers(-(1 << 14), 1 << 14, (S, B)).astype(dtype)
    order = rng.integers(1, 9, S).astype(np.int32)
    shift = rng.integers(0, 16, S).astype(np.int32)
    coeffs = np.zeros((S, 32), np.int32)
    coeffs[:, 24:] = rng.integers(-(1 << 13), 1 << 13, (S, 8))
    seeds = np.zeros((S, 4), dtype)
    rows[fixed], order[fixed], seeds[fixed] = f_rows, f_order, f_seeds
    shift[fixed] = 0
    coeffs[fixed] = 0
    for s in range(S):
        coeffs[s, :32 - order[s]] = 0

    fixed_idx = _t(_padded(fixed, S))
    lpc_idx = _t(_padded(lpc, S)) if with_lpc else None
    idx, args = trec.lpc_lanes_inputs(_t(rows), _t(coeffs), _t(shift),
                                      _t(order), fixed_idx, lpc_idx)
    want_idx = (torch.cat([fixed_idx, lpc_idx]) if with_lpc else fixed_idx)
    assert torch.equal(idx, want_idx)
    rows_t, coeffs_t, shift_g, order_g = args
    n = len(want_idx)
    assert rows_t.shape == (B, n) and coeffs_t.shape == (32, n)
    assert rows_t.dtype == getattr(torch, np.dtype(dtype).name)
    assert coeffs_t.dtype == torch.int32 and coeffs_t.is_contiguous()
    for k, cs in enumerate(trec.FIXED_COEFFS):
        col = np.zeros(32, np.int32)
        col[32 - k:] = cs[::-1]
        lanes = np.nonzero(f_order == k)[0]
        np.testing.assert_array_equal(
            coeffs_t[:, lanes].numpy(),
            np.repeat(col[:, None], len(lanes), 1))
    assert not shift_g[:n_fixed].any()

    out = trec.lpc_reconstruct(*args).t()
    assert launches == [(rows_t.dtype, n)]
    np.testing.assert_array_equal(out[:n_fixed].numpy(), samples)
    assert torch.equal(out[:n_fixed], trec.fixed_integrate(
        _t(f_rows), _t(f_order), _t(f_seeds)))
    if with_lpc:
        at = len(fixed_idx)
        assert torch.equal(
            out[at:at + len(lpc)],
            trec.lpc_scan(_t(rows[lpc]), _t(coeffs[lpc]), _t(shift[lpc]),
                          _t(order[lpc])))


# name -> (rows dtype, value bits, channels, container bits, kinds
# present (3 an lpc subframe, 4 an lpc_wide one), list padding, the lpc
# launches' dtypes, fixed_own_launches).
_PLANS = {
    "int32 stereo, fixed and lpc": (
        np.int32, 16, 2, 16, (0, 1, 2, 3), 1, [torch.int32], 0),
    "int32 stereo, fixed only": (
        np.int32, 16, 2, 16, (0, 1, 2), 1, [torch.int32], 1),
    "int32 stereo, lpc only": (
        np.int32, 16, 2, 16, (0, 3), 1, [torch.int32], 0),
    "int32 stereo, lists padded 3x": (
        np.int32, 16, 2, 16, (0, 1, 2, 3), 3, [torch.int32], 0),
    "int64 stereo, fixed and lpc": (
        np.int64, 24, 2, 32, (0, 2, 3), 1, [torch.int64], 0),
    "int64 mono, fixed only": (
        np.int64, 32, 1, 32, (1, 2), 1, [torch.int64], 1),
    "int32 stereo, fixed, lpc and lpc_wide": (
        np.int32, 16, 2, 16, (2, 3, 4), 1, [torch.int32, torch.int64], 0),
    "int32 mono, fixed and lpc_wide": (
        np.int32, 16, 1, 16, (0, 2, 4), 1, [torch.int32, torch.int64], 1),
}


def _plan(rng, dtype, bits: int, C: int, kinds):
    """Random plan arrays in pad_plan's shapes: F frames of C channels,
    blocks of 64 samples and a last one of 19, every kind of `kinds` in
    the first frames and random after, wasted bits 0-3, the stereo
    channel codes in turn. Rows hold what the indexers write: const
    values at t = 0, fixed warm-ups and differences (with their seeds),
    LPC warm-ups and residuals with coefficients of the order's width
    and shifts 0-15, zero past each block."""
    F, B, last = 9, 64, 19
    S = F * C
    kind = np.concatenate([np.asarray(kinds), rng.choice(kinds, S - len(kinds))])
    bs = np.full(S, B)
    bs[-C:] = last
    rows = np.zeros((S, B), np.int64)
    order = np.zeros(S, np.int32)
    shift = np.zeros(S, np.int32)
    coeffs = np.zeros((S, 32), np.int32)
    seeds = np.zeros((S, 4), np.int64)
    top = 1 << (bits - 2)
    for s in range(S):
        k, n = kind[s], bs[s]
        if k == 0:
            rows[s, 0] = rng.integers(-top, top)
        elif k == 1:
            rows[s, :n] = rng.integers(-top, top, n)
        elif k == 2:
            order[s] = rng.integers(0, 5)
            _, r, sd = _fixed_rows(rng, order[s:s + 1], n, bits - 1,
                                   np.int64)
            rows[s, :n], seeds[s] = r[0], sd[0]
        else:
            order[s] = rng.integers(1, 9)
            shift[s] = rng.integers(0, 16)
            coeffs[s, 32 - order[s]:] = rng.integers(-(1 << 12), 1 << 12,
                                                     order[s])
            rows[s, :n] = rng.integers(-(1 << 10), 1 << 10, n)
            rows[s, :order[s]] = rng.integers(-top, top, order[s])
    wide = kind == 4
    kind[wide] = 3
    codes = ((1, fmt.CH_LEFT_SIDE, fmt.CH_SIDE_RIGHT, fmt.CH_MID_SIDE)
             if C == 2 else (C - 1,))
    arrays = dict(
        rows=rows.astype(dtype), kind=kind.astype(np.int32), order=order,
        wasted=rng.integers(0, 4, S).astype(np.int32), shift=shift,
        coeffs=coeffs, seeds=seeds.astype(dtype),
        channel_code=np.resize(np.asarray(codes, np.int32), F))
    members = {"const": kind == 0, "verbatim": kind == 1, "fixed": kind == 2,
               "lpc": (kind == 3) & ~wide, "lpc_wide": wide}
    return arrays, {name: np.nonzero(m)[0] for name, m in members.items()
                    if m.any()}


@pytest.mark.parametrize("case", list(_PLANS))
def test_reconstruct_core_matches_jax(case, launches, no_cumsum):
    """reconstruct_core (on the plan arrays packed in one buffer, as
    the rows engine stages them) == the JAX package's reconstruct
    (cumsums for the fixed class, the XLA scan for LPC, under x64 for
    int64 rows or an lpc_wide class) on the same arrays, with no
    torch.cumsum:
    one lpc launch over the fixed and lpc classes' lanes (or over the
    one of them the plan has), lpc64 for lpc_wide, and
    `fixed_own_launches` 1 only where the fixed class had no lpc class
    beside it."""
    dtype, bits, C, cb, kinds, pad, kernels, own = _PLANS[case]
    rng = np.random.default_rng(list(_PLANS).index(case))
    arrays, members = _plan(rng, dtype, bits, C, kinds)
    S = len(arrays["kind"])
    class_idx = {name: _padded(m, S, pad) for name, m in members.items()}
    kw = dict(num_channels=C, container_bits=cb, do_decorrelate=C == 2)
    x64 = dtype == np.int64 or "lpc_wide" in class_idx
    with jax.enable_x64(x64):
        want = np.asarray(jrec.reconstruct(
            *(jnp.asarray(arrays[k]) for k in _ORDER),
            {k: jnp.asarray(v) for k, v in class_idx.items()},
            jnp.asarray(arrays["channel_code"]), **kw))
    with recording() as rec:
        got = _core(arrays, class_idx, kw)
    assert got.dtype == getattr(torch, want.dtype.name)
    np.testing.assert_array_equal(got.numpy(), want)
    lanes = sum(len(class_idx[n]) for n in ("fixed", "lpc") if n in class_idx)
    want_launches = [(kernels[0], lanes)]
    if "lpc_wide" in class_idx:
        want_launches.append((torch.int64, len(class_idx["lpc_wide"])))
    assert launches == want_launches
    assert [d for d, _ in launches] == kernels
    assert rec.stats.get("fixed_own_launches", 0) == own


def _stream(case):
    """(stream, input PCM, bits, safe_lpc, fixed_own_launches). A
    12-sample last frame is coded with fixed order 2 by the encoder's
    auto mode, the frames before it with LPC; a fixed subframe_mode
    codes every subframe with it."""
    n = 4 * 1024 + 12
    cfg = EncoderConfig(block_size=1024, stereo_mode=[
        "independent", "left_side", "side_right", "mid_side"])
    bps, safe_lpc, own = 16, False, 0
    if case == "16-bit stereo, every channel code, wasted bits":
        pcm = wasted_bits_signal(n, 2, 16, wasted=3, seed=41)
    elif case == "16-bit stereo, safe_lpc":
        pcm, safe_lpc, own = tone_mix(n, 2, 16, seed=42), True, 1
    elif case == "24-bit stereo, fixed and lpc":
        pcm, bps = tone_mix(n, 2, 24, seed=43), 24
    elif case == "24-bit mono, fixed order 3 only":
        pcm, bps, own = tone_mix(3 * 1024, 1, 24, seed=44), 24, 1
        cfg = EncoderConfig(block_size=1024, subframe_mode=("fixed", 3))
    elif case.startswith("16-bit stereo, fixed order"):
        k = int(case.split()[-2])
        pcm, own = tone_mix(n, 2, 16, seed=45 + k), 1
        cfg = EncoderConfig(block_size=1024, subframe_mode=("fixed", k))
    else:
        raise ValueError(case)
    return encode(pcm, 44100, bps, cfg), pcm, bps, safe_lpc, own


_STREAMS = ["16-bit stereo, every channel code, wasted bits",
            "16-bit stereo, safe_lpc", "24-bit stereo, fixed and lpc",
            "24-bit mono, fixed order 3 only",
            *(f"16-bit stereo, fixed order {k} only" for k in range(5))]


@pytest.mark.skipif(not native_available(), reason="needs native")
@pytest.mark.parametrize("case", _STREAMS)
def test_decode_counts_fixed_lanes(case, launches, no_cumsum):
    """decode on the CPU returns the input PCM (MD5 verified) with no
    torch.cumsum, its `stats` count the plan's fixed subframes and the
    fixed class's own launch, and the core equals the JAX package's
    reconstruct on the plan's padded arrays."""
    data, pcm, bps, safe_lpc, own = _stream(case)
    plan = build_plan(data)
    if safe_lpc:
        plan.wide = plan.kind == 3
    fixed = int(np.count_nonzero(plan.kind == fmt.SF_FIXED))
    assert fixed > 0
    out = zflac_tpu_torch.decode(data, safe_lpc=safe_lpc, device="cpu")
    shift = fmt.normalization_shift(bps)
    np.testing.assert_array_equal(
        out.interleaved, (pcm.astype(np.int64) << shift).reshape(-1).astype(
            out.interleaved.dtype))
    assert (out.stats["fixed_lanes"], out.stats["fixed_own_launches"]) == \
        (fixed, own)
    assert len(launches) == 1 + safe_lpc

    arrays, class_idx = pad_plan(plan)
    jarrays = dict(arrays, kind=plan.kind, seeds=plan.fixed_seeds)
    kw = dict(num_channels=plan.channels, container_bits=fmt.container_bits(
        bps), do_decorrelate=bool(np.any(
            plan.channel_code > fmt.CH_INDEPENDENT_MAX)))
    if case.startswith("16-bit stereo, every"):
        assert set(plan.channel_code) == {
            1, fmt.CH_LEFT_SIDE, fmt.CH_SIDE_RIGHT, fmt.CH_MID_SIDE}
        assert plan.wasted.any() and plan.block_size[-1] == 12
    x64 = arrays["rows"].dtype == np.int64 or safe_lpc
    with jax.enable_x64(x64):
        want = np.asarray(jrec.reconstruct(
            *(jnp.asarray(jarrays[k]) for k in _ORDER),
            {k: jnp.asarray(v) for k, v in class_idx.items()},
            jnp.asarray(arrays["channel_code"]), **kw))
    got = launch_plan(stage_plan(plan), "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_shard_with_fixed_lanes_and_no_lpc_lanes(launches, no_cumsum):
    """reconstruct_sharded over four CPU devices of a stream of three
    LPC frames and a 12-sample fixed one: the last device's slice holds
    the fixed class and no lpc class, so its fixed lanes take a launch
    of their own, one of four lpc launches. The PCM equals the JAX
    function's on its 4-device CPU mesh and the input."""
    pcm = tone_mix(3 * 1024 + 12, 2, 16, seed=31)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    plan = build_plan_py(data)
    arrays, meta = pshard.shard_plan(plan, 4)
    have = [set(pshard.local_plan(arrays, meta, d, 16).class_names) & {
        "fixed", "lpc"} for d in range(4)]
    assert have == [{"lpc"}] * 3 + [{"fixed"}]
    with recording() as rec:
        got, total = reconstruct_sharded(plan, make_mesh(["cpu"] * 4))
    assert rec.stats["fixed_own_launches"] == 1
    assert len(launches) == 4
    want, jtotal = jshard.reconstruct_sharded(
        jbuild_plan_py(data), jshard.make_mesh(jax.devices("cpu")[:4]))
    assert total == jtotal
    np.testing.assert_array_equal(got, want)
    bs = plan.block_size
    flat = np.concatenate([got[f, :bs[f]] for f in range(len(bs))])
    np.testing.assert_array_equal(flat, pcm)
