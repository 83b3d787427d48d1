"""The fixed predictors as LPC lanes (zflac_tpu_torch/runtime/device.py
fixed_cfwd, lpc_launches, class_stack), on the CPU: the fixed
coefficient table through the plain versions of lpc2, lpc2w and
lpc2w33 at hist 8 and shift 0 equals fixed_integrate_t (the seeded
cumsums, which tests/test_torch_ops.py ties to the JAX package) bit for
bit, and class_stack on real chunks equals the stack the cumsum route
gives, with the fixed class in the lpc8 class's launch or in one of its
own, and decode_to_device's `fixed_lanes` and `fixed_own_launches`
counted per stream and chunk mix."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import format as fmt  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct_ref  # noqa: E402
from zflac_tpu_torch.ops.lpc2w import (  # noqa: E402
    lpc2w33_reconstruct_ref,
    lpc2w_reconstruct_ref,
)
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402
from zflac_tpu_torch.runtime.reconstruct import (  # noqa: E402
    FIXED_COEFFS,
    fixed_integrate_t,
)
from zflac_tpu_torch.runtime.wide import join_i64  # noqa: E402
from zflac_tpu_torch.testing import correlated_stereo, tone_mix  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

# kernel's plain version, rows dtype, value bits (32: full-range int32
# values whose sums wrap).
_FORMS = {
    "lpc2 int32 wrapping": (lpc2_reconstruct_ref, np.int32, 32),
    "lpc2w int32 wrapping": (lpc2w_reconstruct_ref, np.int32, 32),
    "lpc2w33 int64 24-bit": (lpc2w33_reconstruct_ref, np.int64, 24),
    "lpc2w33 int64 33-bit": (lpc2w33_reconstruct_ref, np.int64, 33),
}


def _seeds(warm, order, dtype):
    """The scan's finite-difference seeds [4, n] of warm-ups [4, n]
    (pack2_helpers.inc: seed j = the j-th difference at time j, in
    int64, kept in the rows' dtype), zero past each lane's order."""
    tri = np.array([[1, 0, 0, 0], [-1, 1, 0, 0], [1, -2, 1, 0],
                    [-1, 3, -3, 1]], dtype=np.int64)
    seeds = tri @ warm.astype(np.int64)
    seeds[np.arange(4)[:, None] >= order[None, :]] = 0
    return seeds.astype(dtype)


@pytest.mark.parametrize("orders", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("form", list(_FORMS))
def test_fixed_coeffs_through_lpc_kernels_match_cumsums(form, orders):
    """The LPC kernels' plain versions with fixed_cfwd's coefficients,
    shift 0 and the warm-ups in the rows equal fixed_integrate_t with
    the scan's seeds, bit for bit: in int32 with full-range residuals
    whose sums wrap (lpc2, lpc2w), and in int64 with 24- and 33-bit
    values (lpc2w33)."""
    ref, dtype, bits = _FORMS[form]
    rng = np.random.default_rng(
        (list(_FORMS).index(form), 5 if orders == "mixed" else orders))
    B, n = 256, 40
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    rows = rng.integers(lo, hi, (B, n), dtype=np.int64).astype(dtype)
    order = (rng.integers(0, 5, n) if orders == "mixed"
             else np.full(n, orders)).astype(np.int32)
    seeds = _seeds(rows[:4], order, dtype)
    order_t = torch.from_numpy(order)
    cfwd = rt.fixed_cfwd(order_t)
    assert cfwd.shape == (8, n) and cfwd.dtype == torch.int32
    for k, coeffs in enumerate(FIXED_COEFFS):
        col = np.zeros(8, dtype=np.int32)
        col[:k] = coeffs
        np.testing.assert_array_equal(cfwd[:, order == k].numpy(),
                                      np.repeat(col[:, None],
                                                (order == k).sum(), 1))
    got = ref(torch.from_numpy(rows), cfwd,
              torch.zeros(n, dtype=torch.int32), order_t)
    want = fixed_integrate_t(torch.from_numpy(rows), order_t,
                             torch.from_numpy(seeds))
    assert got.dtype == want.dtype == getattr(torch, np.dtype(dtype).name)
    assert torch.equal(got, want)


def _encoded(case):
    """(stream, input PCM, bits, chunk_frames, kernel, fixed subframes,
    chunks whose fixed lanes take a launch of their own). A 12-sample
    last frame is coded with fixed order 2 by the encoder's auto mode
    (blocks of at most twice the LPC order), the frames before it with
    LPC; a fixed subframe_mode codes every subframe with it."""
    n = 3 * 1024 + 12
    bps, chunk_frames = 16, 0
    kernel, fixed, own = "lpc2", 2, 0
    cfg = EncoderConfig(block_size=1024)
    if case == "fixed and lpc8":
        pcm = tone_mix(n, 2, 16, seed=31)
    elif case == "fixed and lpc8, one frame a chunk":
        pcm, chunk_frames, own = tone_mix(n, 2, 16, seed=31), 1, 1
    elif case == "fixed and lpc16":
        pcm, own = tone_mix(n, 2, 16, seed=32), 1
        cfg = EncoderConfig(block_size=1024, max_lpc_order=16)
    elif case == "fixed order 4 only":
        pcm, fixed, own = tone_mix(4 * 1024, 2, 16, seed=33), 8, 1
        cfg = EncoderConfig(block_size=1024, subframe_mode=("fixed", 4))
    elif case == "24-bit fixed and lpc8":
        pcm, bps, kernel = tone_mix(n, 2, 24, seed=34), 24, "lpc2w"
    elif case == "24-bit fixed order 3 only":
        pcm, bps, kernel = tone_mix(4 * 1024, 1, 24, seed=35), 24, "lpc2w"
        fixed, own = 4, 1
        cfg = EncoderConfig(block_size=1024, subframe_mode=("fixed", 3))
    elif case == "wide fixed and lpc8":
        pcm, bps, kernel = correlated_stereo(n, 32, seed=36), 32, "lpc2w33"
        cfg = EncoderConfig(block_size=1024, stereo_mode="mid_side")
    elif case == "wide fixed order 2 only":
        pcm, bps, kernel = correlated_stereo(4 * 1024, 32, seed=37), 32, \
            "lpc2w33"
        fixed, own = 8, 1
        cfg = EncoderConfig(block_size=1024, stereo_mode="mid_side",
                            subframe_mode=("fixed", 2))
    else:
        raise ValueError(case)
    return (encode(pcm, 44100, bps, cfg), pcm, bps, chunk_frames, kernel,
            fixed, own)


def _cumsum_stack(rows_t, buf, geom, cb):
    """class_stack as the cumsum route builds it: the fixed class by
    fixed_integrate_t with the scan's seeds, each LPC class in a launch
    of its own."""
    order = geom.sect(buf, "order", geom.Ssort)
    seeds_t = geom.sect(buf, "seeds", geom.Ssort * 4).view(4, geom.Ssort)
    if geom.wide:
        seeds_t = join_i64(
            geom.sect(buf, "seeds_hi", geom.Ssort * 4).view(4, geom.Ssort),
            seeds_t)
    lpc = rt.lpc_class_inputs(rows_t, buf, geom)
    lpc_fn = rt.LPC_KERNELS[rt.lpc_kernel(geom, cb)]
    segs = []
    for name, sl in rt._class_slices(geom):
        rc = rows_t[:, sl]
        if name == "const":
            segs.append(rc[0:1].expand(geom.Bp, rc.shape[1]))
        elif name == "verbatim":
            segs.append(rc)
        elif name == "fixed":
            segs.append(fixed_integrate_t(rc, order[sl], seeds_t[:, sl]))
        else:
            segs.append(lpc_fn(*lpc[name]))
    segs.append(torch.zeros((geom.Bp, 1), dtype=rows_t.dtype))
    return torch.cat(segs, dim=1)


_CASES = ["fixed and lpc8", "fixed and lpc8, one frame a chunk",
          "fixed and lpc16", "fixed order 4 only", "24-bit fixed and lpc8",
          "24-bit fixed order 3 only", "wide fixed and lpc8",
          "wide fixed order 2 only"]


@pytest.mark.parametrize("case", _CASES)
def test_class_stack_runs_fixed_lanes_in_the_lpc_kernel(case):
    """Every chunk of the stream: class_stack equals the cumsum route's
    stack; lpc_launches merges the fixed class into the lpc8 class's
    launch where the chunk has one, else gives it its own at hist 8;
    decode_to_device returns the input PCM and counts the stream's fixed
    subframes and the chunks whose fixed lanes had a launch of their
    own."""
    data, pcm, bps, chunk_frames, kernel, fixed, own = _encoded(case)
    cb = fmt.container_bits(bps)
    br = BitReader(data)
    cks = rt.stream_chunks(data, parse_metadata(br), br.pos // 8,
                           chunk_frames=chunk_frames)
    assert len(cks) == (4 if chunk_frames else 1)
    seen_fixed = seen_own = 0
    for ck in cks:
        buf, geom = rt.chunk_to_torch(ck, "cpu")
        assert rt.lpc_kernel(geom, cb) == kernel
        assert geom.wide == (kernel == "lpc2w33")
        names = [name for name, _ in geom.classes]
        rows_t = rt.residual_rows(buf, geom)
        launches = rt.lpc_launches(rows_t, buf, geom)
        if "fixed" in names:
            seen_fixed += sum(n for name, n, _ in ck.classes
                              if name == "fixed")
            seen_own += "lpc8" not in names
            n_fixed = dict(geom.classes)["fixed"]
            lanes = n_fixed + dict(geom.classes).get("lpc8", 0)
            rows_f, cfwd_f, shift_f, _ = launches["fixed"]
            assert rows_f.shape[1] == cfwd_f.shape[1] == lanes
            assert cfwd_f.shape[0] == 8 and not shift_f[:n_fixed].any()
            assert "lpc8" not in launches
        assert set(launches) == {"fixed" if name == "lpc8" and
                                 "fixed" in names else name
                                 for name in names if name not in
                                 ("const", "verbatim")}
        got = rt.class_stack(rows_t, buf, geom, container_bits=cb)
        want = _cumsum_stack(rows_t, buf, geom, cb)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert (seen_fixed, seen_own) == (fixed, own)

    dd = zflac_tpu_torch.decode_to_device(data, device="cpu",
                                          chunk_frames=chunk_frames)
    assert dd.stats["chunks"] == len(cks)
    assert dd.stats["fixed_lanes"] == fixed
    assert dd.stats["fixed_own_launches"] == own
    out = dd.to_host()          # MD5 verified
    shift = fmt.normalization_shift(bps)
    np.testing.assert_array_equal(
        out.interleaved, (pcm.astype(np.int64) << shift).reshape(-1).astype(
            out.interleaved.dtype))


@pytest.mark.parametrize("name", ["fixed order 2", "blocksize 16",
                                  "lpc order 8"])
def test_corpus_fixed_lanes_counted(name, corpus):
    """Corpus streams: every subframe of "fixed order 2" and "blocksize
    16" (blocks of 16 samples, which the encoder's auto mode codes with
    fixed order 2) is a fixed lane, in one chunk whose fixed lanes have
    a launch of their own; "lpc order 8" has none. The stack equals the
    cumsum route's."""
    data, pcm, _sr, bps = corpus[name]
    br = BitReader(data)
    info = parse_metadata(br)
    ck, = rt.stream_chunks(data, info, br.pos // 8)
    buf, geom = rt.chunk_to_torch(ck, "cpu")
    rows_t = rt.residual_rows(buf, geom)
    cb = fmt.container_bits(bps)
    assert torch.equal(rt.class_stack(rows_t, buf, geom, container_bits=cb),
                       _cumsum_stack(rows_t, buf, geom, cb))
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu")
    subframes = ck.F * ck.C
    want = (0, 0) if name == "lpc order 8" else (subframes, 1)
    assert (dd.stats["fixed_lanes"], dd.stats["fixed_own_launches"]) == want
