"""The PyTorch port's decode_to_device (zflac_tpu_torch) against the JAX
package's on the CPU, for the stereo corpus streams of <= 16 bits that
exercise stereo decorrelation, bit depths, wasted bits and STREAMINFO
fields, and for the stop cut at a STREAMINFO total (tolerance zero)."""

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402
from torch_slice import (  # noqa: E402
    FORMAT_STREAMS,
    assert_same,
    check_rows_engine,
    check_stream,
    with_total,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


@pytest.mark.parametrize("name", FORMAT_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", FORMAT_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("total,kw", [
    (3072, {}),                     # frame 3 starts at the total: cut
    (1024, dict(chunk_frames=2)),   # cut in the first of several chunks
    (3000, {}),                     # frame 2 crosses it: keep all
])
def test_stop_cut_matches_jax(total, kw, corpus):
    """A fudged STREAMINFO total gets the JAX package's stop cut."""
    data = with_total(corpus["lpc order 8"][0], total)
    dd = zflac_tpu_torch.decode_to_device(data, device="cpu", **kw)
    ref = zflac_tpu.decode_to_device(data, **kw)
    assert_same(dd, ref, verify_md5=False)
    if total % 1024 == 0:
        assert dd.total_samples == total
