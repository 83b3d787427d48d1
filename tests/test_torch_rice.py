"""The port's Rice group-table math (zflac_tpu_torch/ops/rice.py) and
skim scans (index/native_indexer.py build_plan_skim, skim_range) on the
CPU, tolerance zero: on every corpus stream, rows_from_groups on the
port's plan equals the plan's host rows in the int32 wrap domain, as
tests/test_rice_kernel.py holds the JAX package's, and equals the JAX
package's rows_from_groups on the JAX plan; the skim plans equal the
JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zflac_tpu.index import native_indexer as jni  # noqa: E402
from zflac_tpu.ops import rice as jrice  # noqa: E402

from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.index import native_indexer as ni  # noqa: E402
from zflac_tpu_torch.ops import rice  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402

from torch_slice import ALL_STREAMS, assert_deep_equal  # noqa: E402

pytestmark = pytest.mark.skipif(
    not jni.native_available(), reason="native indexer unavailable")

# The skim scans are held to the JAX package's on every third stream.
SKIM_STREAMS = ALL_STREAMS[::3]


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_rows_match_host(name, corpus):
    """Rice-coded residuals always fit int32 (RFC 9639), so the rows
    are compared in the int32 wrap domain; warm-up and verbatim
    positions come from the host rows on both sides."""
    data = corpus[name][0]
    plan = ni.build_plan_native(data, emit_groups=True)
    rows = rice.rows_from_groups(data, plan, device="cpu")
    assert rows.dtype == np.int32
    np.testing.assert_array_equal(rows, plan.rows.astype(np.int32))


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_rows_match_jax(name, corpus):
    data = corpus[name][0]
    got = rice.rows_from_groups(
        data, ni.build_plan_native(data, emit_groups=True), device="cpu")
    want = jrice.rows_from_groups(
        data, jni.build_plan_native(data, emit_groups=True), impl="jnp")
    np.testing.assert_array_equal(got, want)


def test_group_table_sanity(corpus):
    data, *_ = corpus["lpc order 8"]
    plan = ni.build_plan_native(data, emit_groups=True)
    g = plan.groups
    valid = g["k"] != rice.K_INVALID
    # Most groups of a Rice-coded stream are extraction-eligible.
    assert valid.mean() > 0.5
    # Offsets strictly increase along each subframe's valid groups.
    for s in range(plan.num_subframes):
        offs = g["off"][s][valid[s]]
        assert np.all(np.diff(offs) > 0)


def test_unpack_math_shift_rules():
    """The uint32 helpers on int64 follow XLA: logical shifts by 32 or
    more give 0, the bitcast wraps, leading zeros of 0 are 32."""
    u = torch.tensor([0, 1, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    assert rice._clz32(u).tolist() == [32, 31, 0, 0]
    assert rice.bitcast_i32(u).tolist() == [0, 1, -2**31, -1]
    s = torch.tensor([0, 31, 32, 40], dtype=torch.int64)
    assert rice._shl(u, s).tolist() == [0, 0x80000000, 0, 0]
    assert rice._shr(u, s).tolist() == [0, 0, 0, 0]
    assert rice._shr(u, torch.full_like(u, 31)).tolist() == [0, 0, 1, 1]


@pytest.mark.parametrize("name", SKIM_STREAMS)
def test_build_plan_skim_matches_jax(name, corpus):
    data = corpus[name][0]
    got, want = ni.build_plan_skim(data), jni.build_plan_skim(data)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.rows is None
        assert_deep_equal(got, want, name)


@pytest.mark.parametrize("name", SKIM_STREAMS)
def test_skim_range_matches_jax(name, corpus):
    """The whole stream's frames, then those from the second frame on;
    where skim declines the stream's sample type, both raise the same
    error class."""
    data = corpus[name][0]
    br = BitReader(data)
    info = parse_metadata(br)
    if ni.build_plan_skim(data) is None:
        errs = []
        for fn, mod in ((ni.skim_range, ni), (jni.skim_range, jni)):
            with pytest.raises(mod.err.FlacError) as e:
                fn(data, br.pos // 8, len(data), info)
            errs.append(type(e.value).__name__)
        assert errs[0] == errs[1]
        return
    starts = [br.pos // 8]
    offsets = ni.build_plan_native(data).frame_byte_offset
    if len(offsets) > 1:
        starts.append(int(offsets[1]))
    for start in starts:
        got = ni.skim_range(data, start, len(data), info)
        want = jni.skim_range(data, start, len(data), info)
        assert got[1] == want[1]
        assert_deep_equal(got[0], want[0], f"{name} from {start}")
