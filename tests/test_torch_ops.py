"""The PyTorch port (zflac_tpu_torch) against the JAX package, one
kernel module at a time: the plain PyTorch version of each CUDA kernel
(rice16, lpc2, packtail) and the fixed-order integration, fed the same
numpy inputs as the JAX function, must agree bit for bit (tolerance
zero: these are exact integer decodes). The JAX side runs as its own
CPU tests run it: the Pallas kernels in interpret mode, and the XLA
reference math. The CUDA kernels themselves are checked against these
plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu.index.native_indexer import (  # noqa: E402
    native_available,
    pack2_range,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def _first_chunk(data):
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 20)
    assert ck is not None
    return ck


def _random_groups(rng, W, NG, adversarial=False):
    """Random windows and meta words with Rice, escape, invalid and
    skip groups (the group-table mix of test_kernels.py); adversarial:
    the whole 6-bit k, skips 0-8 and sparse windows whose unary runs
    cross words (zflac_tpu_torch/tools/kernel_inputs.py)."""
    from zflac_tpu.ops.rice16 import K2_ESCAPE, K2_INVALID
    from zflac_tpu_torch.tools import kernel_inputs
    assert (kernel_inputs.K2_ESCAPE, kernel_inputs.K2_INVALID) == (
        K2_ESCAPE, K2_INVALID)
    return kernel_inputs.rice_groups(rng, W, NG, adversarial)


# (W, Ssort, GP1, adversarial); the first four keep their ids.
_RICE_CASES = [
    *(pytest.param(W, S, G, False, id=f"{W}-{S}-{G}")
      for W, S, G in ((8, 1024, 2), (16, 1024, 2), (8, 384, 2),
                      (16, 256, 2))),
    *(pytest.param(W, S, G, True, id=f"{W}-{S}-{G}-adversarial")
      for W, S, G in ((8, 1024, 2), (16, 1024, 2), (8, 384, 3),
                      (16, 256, 3))),
]


@pytest.mark.parametrize("W,Ssort,GP1,adversarial", _RICE_CASES)
def test_rice16_matches_jax(W, Ssort, GP1, adversarial):
    """rice16 plain version == unpack16_rows_math and the Pallas rows
    kernel in interpret mode (4-D form when Ssort % 1024 == 0, 2-D
    form otherwise), over escape, invalid and skip groups, and in the
    adversarial cases over Rice parameters up to 61 and unary runs
    across words and past the read-position bound."""
    from zflac_tpu.ops.rice16 import (rice16_unpack_rows_inline,
                                      unpack16_rows_math)
    from zflac_tpu_torch.ops.rice16 import (rice16_unpack_rows,
                                            rice16_unpack_rows_ref)

    rng = np.random.default_rng(W * 1000 + Ssort + 7 * adversarial)
    win, meta = _random_groups(rng, W, GP1 * Ssort, adversarial)
    if adversarial:
        k6 = (meta >> 5) & 63
        assert (k6 > 32).any() and (k6 < 32).any() and \
            ((meta >> 16) & 31).max() == 8 and (win == 0).all(axis=0).any()
    jw, jm = jnp.asarray(win), jnp.asarray(meta[None, :])
    want = np.asarray(jax.jit(
        lambda w, m: unpack16_rows_math(w, m, Ssort=Ssort))(jw, jm))
    want_k = np.asarray(jax.jit(
        lambda w, m: rice16_unpack_rows_inline(
            w, m, Ssort=Ssort, interpret=True))(jw, jm))
    np.testing.assert_array_equal(want_k, want)

    tw = torch.from_numpy(win.view(np.int32))
    tm = torch.from_numpy(meta)
    got = rice16_unpack_rows_ref(tw, tm, Ssort=Ssort)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rice16_unpack_rows(tw, tm, Ssort=Ssort).numpy(), want)


def test_rice16_real_chunk_matches_jax(corpus):
    """rice16 plain version == the JAX math on a scanned chunk's own
    windows (escaped partitions)."""
    from zflac_tpu.ops.rice16 import unpack16_rows_math
    from zflac_tpu_torch.ops.rice16 import rice16_unpack_rows_ref

    ck = _first_chunk(corpus["escaped partitions"][0])
    off, W, NG = ck.off, ck.W, ck.NGp
    win = ck.buf[off["win"]:off["win"] + W * NG].reshape(W, NG)
    meta = ck.buf[off["meta"]:off["meta"] + NG]
    want = np.asarray(jax.jit(
        lambda w, m: unpack16_rows_math(w, m, Ssort=ck.Ssort))(
        jnp.asarray(win.view(np.uint32)), jnp.asarray(meta[None, :])))
    got = rice16_unpack_rows_ref(torch.from_numpy(win.copy()),
                                 torch.from_numpy(meta.copy()),
                                 Ssort=ck.Ssort)
    np.testing.assert_array_equal(got.numpy(), want)


def _lpc_inputs(rng, n, B, hist):
    """Warm-ups then residuals, orders 1..hist, shifts 0..15 and
    15-bit coefficients: the predictions overflow int32, so the
    recurrence runs in wraparound."""
    order = rng.integers(1, hist + 1, n).astype(np.int32)
    shift = rng.integers(0, 16, n).astype(np.int32)
    cf = np.zeros((n, 32), np.int32)
    for i in range(n):
        cf[i, :order[i]] = rng.integers(-(1 << 14), 1 << 14, order[i])
    rows = rng.integers(-(1 << 15), 1 << 15, (n, B)).astype(np.int32)
    return rows, cf, shift, order


@pytest.mark.parametrize("hist", [8, 16, 32])
@pytest.mark.parametrize("B", [128, 640, 1152])
def test_lpc2_matches_jax(hist, B):
    """lpc2 plain version == the Pallas lpc2 kernel in interpret mode
    and the XLA scan (_lpc_scan), in int32 wraparound."""
    from zflac_tpu.ops.lpc2 import lpc2_reconstruct_inline
    from zflac_tpu.runtime.reconstruct import _lpc_scan
    from zflac_tpu_torch.ops.lpc2 import (lpc2_reconstruct,
                                          lpc2_reconstruct_ref)

    rng = np.random.default_rng(hist * 10000 + B)
    n = 128
    rows, cf, shift, order = _lpc_inputs(rng, n, B, hist)
    want = np.asarray(jax.jit(_lpc_scan)(
        jnp.asarray(rows), jnp.asarray(cf[:, ::-1].copy()),
        jnp.asarray(shift), jnp.asarray(order))).T
    assert np.abs(want.astype(np.int64)).max() > 1 << 24
    want_k = np.asarray(lpc2_reconstruct_inline(
        jnp.asarray(rows.T.copy()), jnp.asarray(cf[:, :hist].T.copy()),
        jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]),
        lanes=n, hist=hist, unroll=8, interpret=True))
    np.testing.assert_array_equal(want_k, want)

    args = (torch.from_numpy(rows.T.copy()),
            torch.from_numpy(cf[:, :hist].T.copy()),
            torch.from_numpy(shift), torch.from_numpy(order))
    got = lpc2_reconstruct_ref(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(lpc2_reconstruct(*args).numpy(), want)


def test_lpc2_strided_column_slice():
    """The wrapper takes a class's lane slice of the wider rows array
    (contiguous rows, row stride Ssort) as the pack2 path passes it."""
    from zflac_tpu_torch.ops.lpc2 import (lpc2_reconstruct,
                                          lpc2_reconstruct_ref)

    rng = np.random.default_rng(3)
    rows, cf, shift, order = _lpc_inputs(rng, 384, 256, 8)
    wide = torch.from_numpy(rows.T.copy())          # [B, 384]
    cfw = torch.from_numpy(cf.T.copy())             # [32, 384]
    sl = slice(128, 256)
    got = lpc2_reconstruct(wide[:, sl], cfw[:8, sl],
                           torch.from_numpy(shift[sl]),
                           torch.from_numpy(order[sl]))
    want = lpc2_reconstruct_ref(wide[:, sl].contiguous(),
                                cfw[:8, sl].contiguous(),
                                torch.from_numpy(shift[sl]),
                                torch.from_numpy(order[sl]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("orders", [0, 1, 2, 3, 4, "mixed"])
def test_fixed_integrate_matches_jax(orders):
    """fixed_integrate_t == the JAX _fixed_integrate_t for orders 0-4,
    with values large enough that the cumsums wrap int32."""
    from zflac_tpu.runtime.reconstruct import _fixed_integrate_t
    from zflac_tpu_torch.runtime.reconstruct import fixed_integrate_t

    rng = np.random.default_rng(42 if orders == "mixed" else orders)
    B, n = 512, 128
    rows = rng.integers(-(1 << 30), 1 << 30, (B, n)).astype(np.int32)
    order = (rng.integers(0, 5, n) if orders == "mixed"
             else np.full(n, orders)).astype(np.int32)
    seeds = rng.integers(-(1 << 30), 1 << 30, (4, n)).astype(np.int32)
    want = np.asarray(jax.jit(_fixed_integrate_t)(
        jnp.asarray(rows), jnp.asarray(order), jnp.asarray(seeds)))
    got = fixed_integrate_t(torch.from_numpy(rows), torch.from_numpy(order),
                            torch.from_numpy(seeds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_packtail_math(stack, inv, wasted, chcode, cb):
    """The JAX package's XLA stereo tail (zflac_tpu/runtime/device.py
    _reconstruct_pack2_core, use_pallas=False: the plane gathers,
    decorrelate2, pack2ch) before the bitcast, on the same arrays."""
    from zflac_tpu import format as fmt
    stack, inv, wasted, chcode = map(jnp.asarray, (stack, inv, wasted,
                                                  chcode))
    c0 = stack[inv[0::2]] << wasted[0::2][:, None]
    c1 = stack[inv[1::2]] << wasted[1::2][:, None]
    mode = chcode[:, None]
    mid = (c0 << 1) | (c1 & 1)
    new0 = jnp.where(
        mode == fmt.CH_SIDE_RIGHT, c0 + c1,
        jnp.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
    new1 = jnp.where(
        mode == fmt.CH_LEFT_SIDE, c0 - c1,
        jnp.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
    if cb == 16:
        return np.asarray((new0 & 0xFFFF) | (new1 << 16))
    return np.asarray(((new0 & 0xFF) | (new1 << 8)).astype(jnp.int16))


@pytest.mark.parametrize("name", ["stereo independent", "stereo left_side",
                                  "stereo side_right", "stereo mid_side",
                                  "wasted bits", "bps 8",
                                  "synthetic container 16",
                                  "synthetic container 8"])
def test_packtail_matches_jax(name, corpus):
    """packtail plain version == the Pallas packtail kernel in
    interpret mode on the JAX stage="transpose" stack of a real chunk
    (all four stereo modes, wasted bits, containers 16 and 8), and on
    synthetic stacks (kernel_inputs.packtail_inputs: int32 values that
    wrap, an inv permutation, wasted amounts -3..40, every channel
    code), also against the JAX package's XLA tail math."""
    from zflac_tpu import format as fmt
    from zflac_tpu.ops.packtail import packtail_inline
    from zflac_tpu.runtime.device import _reconstruct_pack2_core
    from zflac_tpu_torch.ops.packtail import packtail, packtail_ref
    from zflac_tpu_torch.tools.kernel_inputs import packtail_inputs

    if name.startswith("synthetic"):
        cb = int(name.split()[-1])
        Fp = 12
        stack, inv, wasted, chcode = packtail_inputs(
            np.random.default_rng(cb), Fp, 256)
        assert wasted.min() < 0 and wasted.max() > 31
        assert set(chcode) == {1, 8, 9, 10}
        want = _jax_packtail_math(stack, inv, wasted, chcode, cb)
    else:
        ck = _first_chunk(corpus[name][0])
        cb = fmt.container_bits(ck.bits_per_sample)
        spec = ck.spec_key()
        Fp, Sp = spec[0], spec[1]
        off = ck.off
        buf = jnp.asarray(ck.device_buf)

        stack = np.asarray(jax.jit(lambda b: _reconstruct_pack2_core(
            b, spec=spec, num_channels=2, container_bits=cb,
            do_decorrelate=ck.do_decorrelate, use_pallas=False,
            stage="transpose"))(buf))
        inv = ck.buf[off["inv"]:off["inv"] + Sp]
        wasted = ck.buf[off["wasted"]:off["wasted"] + Sp]
        chcode = ck.buf[off["chcode"]:off["chcode"] + Fp]
        want = None
    want_k = np.asarray(packtail_inline(
        jnp.asarray(stack), jnp.asarray(inv), jnp.asarray(wasted),
        jnp.asarray(chcode), Fp=Fp, container_bits=cb, interpret=True))

    args = tuple(torch.from_numpy(a.copy())
                 for a in (stack, inv, wasted, chcode))
    got = packtail_ref(*args, Fp=Fp, container_bits=cb)
    if cb == 8:
        assert got.dtype == torch.int16
        want_k = want_k.astype(np.int16)
    else:
        assert got.dtype == torch.int32
    if want is not None:
        np.testing.assert_array_equal(want_k, want)
    np.testing.assert_array_equal(got.numpy(), want_k)
    np.testing.assert_array_equal(
        packtail(*args, Fp=Fp, container_bits=cb).numpy(), want_k)
