"""The PyTorch port's 64-bit pieces (zflac_tpu_torch) against the JAX
package on the CPU: the plain versions of the lpc2w and lpc2w33 CUDA
kernels against the JAX step math (lax.scan) and the Pallas kernels in
interpret mode, over the whole shift range; the int64 fixed-order
integration and decorrelation against the JAX (hi, lo) pair library;
and join_i64 / split_i64. Tolerance zero: exact integer decodes. The
same numpy inputs, made from a seed, go to both packages; the JAX pair
outputs are compared through split_i64. The CUDA kernels themselves
are held to these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu import format as fmt  # noqa: E402

from zflac_tpu_torch.runtime.wide import (  # noqa: E402
    join_i64,
    split_i64,
    wrap_to,
)


def _pair(x):
    """numpy int64 -> (hi, lo) int32 words, as the scan writes them."""
    return ((x >> 32).astype(np.int32),
            (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32))


def _hires_inputs(rng, n, B, hist, warm_bits):
    """High-res recurrences: orders 1..hist, shifts 10..15,
    coefficients up to 15 bits with sum|c| <= 2^shift (the recurrence
    stays bounded), warm-ups of `warm_bits` bits (near +-2^29 for
    24-bit-like, +-2^32 for 33-bit side channels) and small residuals,
    so the 64-bit sums pass 2^32 by far."""
    order = rng.integers(1, hist + 1, n).astype(np.int32)
    shift = rng.integers(10, 16, n).astype(np.int32)
    cf = np.zeros((hist, n), np.int32)
    rows = rng.integers(-1024, 1025, (B, n)).astype(np.int64)
    lim = 1 << (warm_bits - 1)
    for i in range(n):
        o = order[i]
        cap = max(1, (1 << int(shift[i])) // int(o))
        cf[:o, i] = rng.integers(-cap, cap + 1, o)
        rows[:o, i] = rng.integers(-lim, lim, o)
    return rows, cf, shift, order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hist", [8, 16, 32])
@pytest.mark.parametrize("B", [128, 640, 1152])
def test_lpc2w_matches_jax(hist, B):
    """lpc2w plain version == lpc2w_scan and the Pallas lpc2w kernel in
    interpret mode, with products beyond 2^32."""
    from zflac_tpu.ops.lpc2w import lpc2w_reconstruct_inline, lpc2w_scan
    from zflac_tpu_torch.ops.lpc2w import (lpc2w_reconstruct,
                                           lpc2w_reconstruct_ref)

    rng = np.random.default_rng(hist * 10000 + B + 1)
    n = 128
    rows, cf, shift, order = _hires_inputs(rng, n, B, hist, 30)
    rows = rows.astype(np.int32)
    jargs = (jnp.asarray(rows), jnp.asarray(cf),
             jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]))
    want = np.asarray(jax.jit(
        lambda *a: lpc2w_scan(*a, hist=hist))(*jargs))
    assert np.abs(want.astype(np.int64)).max() > 1 << 28
    want_k = np.asarray(lpc2w_reconstruct_inline(
        *jargs, lanes=n, hist=hist, unroll=8, interpret=True))
    np.testing.assert_array_equal(want_k, want)

    args = (_t(rows), _t(cf), _t(shift), _t(order))
    got = lpc2w_reconstruct_ref(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(lpc2w_reconstruct(*args).numpy(), want)


@pytest.mark.parametrize("hist", [8, 16, 32])
@pytest.mark.parametrize("B", [128, 640, 1152])
def test_lpc2w33_matches_jax(hist, B):
    """lpc2w33 plain version (int64) == lpc2w33_scan and the Pallas
    lpc2w33 kernel in interpret mode (hi, lo pairs), on 33-bit
    warm-ups."""
    from zflac_tpu.ops.lpc2w import (lpc2w33_reconstruct_inline,
                                     lpc2w33_scan)
    from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct,
                                           lpc2w33_reconstruct_ref)

    rng = np.random.default_rng(hist * 10000 + B + 2)
    n = 128
    rows, cf, shift, order = _hires_inputs(rng, n, B, hist, 33)
    hi, lo = _pair(rows)
    jargs = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cf),
             jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]))
    want = [np.asarray(w) for w in jax.jit(
        lambda *a: lpc2w33_scan(*a, hist=hist))(*jargs)]
    assert np.abs(want[0]).max() > 0         # samples beyond 32 bits
    want_k = lpc2w33_reconstruct_inline(
        *jargs, lanes=n, hist=hist, unroll=8, interpret=True)
    for a, b in zip(want_k, want):
        np.testing.assert_array_equal(np.asarray(a), b)

    args = (_t(rows), _t(cf), _t(shift), _t(order))
    for got in (lpc2w33_reconstruct_ref(*args),
                lpc2w33_reconstruct(*args)):
        assert got.dtype == torch.int64
        for a, b in zip(split_i64(got), want):
            np.testing.assert_array_equal(a.numpy(), b)


# The scan writes the 5-bit shift field (0..31); the rest are amounts
# only a corrupt buffer holds, where the JAX step math's uint32 shifts
# give lpc2w pred 0 and lpc2w33 the sign fill of the high word.
_SHIFTS = np.array([0, 1, 2, 7, 15, 16, 30, 31, 32, 33, 40, 63, 64, 100,
                    -1, -32, 2**31 - 1, -2**31], np.int32)


@pytest.mark.parametrize("kernel", ["lpc2w", "lpc2w33"])
def test_lpc2w_shift_range_matches_jax(kernel):
    """Both plain versions equal the JAX scans for every shift amount
    the buffer's field can carry, and for out-of-range ones, on
    accumulators of both signs."""
    from zflac_tpu.ops import lpc2w as jw
    from zflac_tpu_torch.ops import lpc2w as tw

    rng = np.random.default_rng(5)
    hist, B = 8, 64
    n = len(_SHIFTS) * 8
    rows, cf, _, order = _hires_inputs(rng, n, B, hist,
                                       33 if kernel == "lpc2w33" else 30)
    shift = np.repeat(_SHIFTS, 8)
    tail = (jnp.asarray(cf), jnp.asarray(shift[None, :]),
            jnp.asarray(order[None, :]))
    targs = (_t(cf), _t(shift), _t(order))
    if kernel == "lpc2w":
        rows = rows.astype(np.int32)
        want = np.asarray(jax.jit(lambda *a: jw.lpc2w_scan(
            *a, hist=hist))(jnp.asarray(rows), *tail))
        got = tw.lpc2w_reconstruct_ref(_t(rows), *targs)
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        hi, lo = _pair(rows)
        want = jax.jit(lambda *a: jw.lpc2w33_scan(*a, hist=hist))(
            jnp.asarray(hi), jnp.asarray(lo), *tail)
        got = tw.lpc2w33_reconstruct_ref(_t(rows), *targs)
        for a, b in zip(split_i64(got), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# Lags a 32-lane group's coefficients reach, in turn (the histories the
# kernels pick per warp), and the out-of-range shift amounts of _SHIFTS.
_GROUP_LAGS = (8, 16, 32)
_BAD_SHIFTS = _SHIFTS[8:]


@pytest.mark.parametrize("pattern", ["lags", "oldest", "shifts"])
@pytest.mark.parametrize("n", [1, 31, 33, 97])
def test_lpc2w33_warp_patterns_match_jax(n, pattern):
    """lpc2w33's plain version == lpc2w33_scan and the Pallas lpc2w33
    kernel in interpret mode on the inputs that drive the kernel's
    per-warp picks, at hist 32: lanes 32g..32g+31 with coefficients up
    to lag 8, 16 and 32 in turn ('lags'); that, and the last lane's one
    nonzero coefficient in the oldest row ('oldest'); and the last
    group's lanes on the out-of-range shift amounts ('shifts')."""
    from zflac_tpu.ops.lpc2w import (lpc2w33_reconstruct_inline,
                                     lpc2w33_scan)
    from zflac_tpu_torch.ops.lpc2w import (lpc2w33_reconstruct,
                                           lpc2w33_reconstruct_ref)

    hist, B = 32, 64
    rng = np.random.default_rng(n * 10 + len(pattern))
    rows, cf, shift, order = _hires_inputs(rng, n, B, hist, 33)
    lags = np.array([_GROUP_LAGS[s // 32 % 3] for s in range(n)])
    cf = cf * (np.arange(hist)[:, None] < lags[None, :])
    order = np.minimum(order, lags).astype(np.int32)
    if pattern == "oldest":
        cf[:, -1] = 0
        cf[hist - 1, -1] = 5
    if pattern == "shifts":
        g0 = (n - 1) // 32 * 32
        shift[g0:] = np.resize(_BAD_SHIFTS, n - g0)
    hi, lo = _pair(rows)
    jargs = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cf),
             jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]))
    want = [np.asarray(w) for w in jax.jit(
        lambda *a: lpc2w33_scan(*a, hist=hist))(*jargs)]
    want_k = lpc2w33_reconstruct_inline(
        *jargs, lanes=n, hist=hist, unroll=8, interpret=True)
    for a, b in zip(want_k, want):
        np.testing.assert_array_equal(np.asarray(a), b)

    args = (_t(rows), _t(cf), _t(shift), _t(order))
    for got in (lpc2w33_reconstruct_ref(*args),
                lpc2w33_reconstruct(*args)):
        for a, b in zip(split_i64(got), want):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("kernel", ["lpc2w", "lpc2w33"])
def test_lpc2w_strided_column_slice(kernel):
    """Each wrapper takes a class's lane slice of the wider rows array
    (contiguous rows, row stride Ssort) as the pack2 path passes it."""
    from zflac_tpu_torch.ops import lpc2w as tw

    wrapper = getattr(tw, f"{kernel}_reconstruct")
    ref = getattr(tw, f"{kernel}_reconstruct_ref")
    rng = np.random.default_rng(3)
    rows, cf, shift, order = _hires_inputs(
        rng, 384, 256, 8, 33 if kernel == "lpc2w33" else 30)
    if kernel == "lpc2w":
        rows = rows.astype(np.int32)
    wide = _t(rows)                                 # [B, 384]
    cfw = _t(np.pad(cf, ((0, 24), (0, 0))))         # [32, 384]
    sl = slice(128, 256)
    got = wrapper(wide[:, sl], cfw[:8, sl], _t(shift[sl]), _t(order[sl]))
    want = ref(wide[:, sl].contiguous(), cfw[:8, sl].contiguous(),
               _t(shift[sl]), _t(order[sl]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("orders", [0, 1, 2, 3, 4, "mixed"])
def test_fixed_integrate_int64_matches_jax(orders):
    """fixed_integrate_t on int64 rows == the JAX pair integration
    fixed_integrate_wide_t for orders 0-4, with 33-bit values whose
    sums pass 2^32."""
    from zflac_tpu.runtime.wide import fixed_integrate_wide_t
    from zflac_tpu_torch.runtime.reconstruct import fixed_integrate_t

    rng = np.random.default_rng(43 if orders == "mixed" else orders + 7)
    B, n = 512, 128
    rows = rng.integers(-(1 << 32), 1 << 32, (B, n))
    order = (rng.integers(0, 5, n) if orders == "mixed"
             else np.full(n, orders)).astype(np.int32)
    seeds = rng.integers(-(1 << 32), 1 << 32, (4, n))
    rh, rl = _pair(rows)
    sh, sl = _pair(seeds)
    u32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)  # noqa: E731
    want = jax.jit(lambda rh, rl, o, sh, sl: fixed_integrate_wide_t(
        rh, u32(rl), o, sh, u32(sl)))(
        jnp.asarray(rh), jnp.asarray(rl), jnp.asarray(order),
        jnp.asarray(sh), jnp.asarray(sl))
    got = fixed_integrate_t(_t(rows), _t(order), _t(seeds))
    assert got.dtype == torch.int64
    hi, lo = split_i64(got)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(
        lo.numpy(), np.asarray(want[1]).view(np.int32))


@pytest.mark.parametrize("mode", [1, fmt.CH_LEFT_SIDE, fmt.CH_SIDE_RIGHT,
                                  fmt.CH_MID_SIDE])
def test_decorrelate2_int64_matches_jax(mode):
    """decorrelate2 on int64 planes, cut to the low words, ==
    decorrelate2_wide on pairs, and gives back 32-bit L and R from a
    33-bit side channel, for each stereo channel code."""
    from zflac_tpu.runtime.wide import decorrelate2_wide
    from zflac_tpu_torch.runtime.reconstruct import decorrelate2

    rng = np.random.default_rng(mode)
    F, B = 16, 256
    L = rng.integers(-(1 << 31), 1 << 31, (F, B))
    R = rng.integers(-(1 << 31), 1 << 31, (F, B))
    side = L - R
    c0, c1 = {1: (L, R), fmt.CH_LEFT_SIDE: (L, side),
              fmt.CH_SIDE_RIGHT: (side, R),
              fmt.CH_MID_SIDE: ((L + R) >> 1, side)}[mode]
    modes = np.full((F, 1), mode, np.int32)
    h0, l0 = _pair(c0)
    h1, l1 = _pair(c1)
    u32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)  # noqa: E731
    want = jax.jit(lambda h0, l0, h1, l1, m: decorrelate2_wide(
        h0, u32(l0), h1, u32(l1), m))(
        jnp.asarray(h0), jnp.asarray(l0), jnp.asarray(h1),
        jnp.asarray(l1), jnp.asarray(modes))
    got = decorrelate2(_t(c0), _t(c1), _t(modes))
    for g, w, true in zip(got, want, (L, R)):
        g32 = wrap_to(g, torch.int32).numpy()
        np.testing.assert_array_equal(g32, np.asarray(w))
        np.testing.assert_array_equal(g32, true.astype(np.int32))


def test_join_split_round_trip():
    """split_i64 gives the scan's (hi, lo) words, and join_i64 of them
    gives the int64 values back, over the whole int64 range."""
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64),
        rng.integers(-(1 << 33), 1 << 33, 4096),
        np.array([0, -1, 1 << 32, -(1 << 32), (1 << 31), -(1 << 31) - 1,
                  np.iinfo(np.int64).max, np.iinfo(np.int64).min])])
    hi, lo = split_i64(_t(x))
    assert hi.dtype == lo.dtype == torch.int32
    want_hi, want_lo = _pair(x)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(join_i64(hi, lo).numpy(), x)
