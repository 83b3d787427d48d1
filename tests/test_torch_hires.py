"""The PyTorch port's decode_to_device (zflac_tpu_torch) against the JAX
package's on the CPU, for the corpus streams of 17-32 bits: the 32-bit
container, whose LPC classes run the lpc2w recurrence (64-bit
accumulator), and the 32-bit stereo streams whose 33-bit side channels
make wide chunks (lpc2w33, int64 throughout). Tolerance zero."""

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

from zflac_tpu.index.native_indexer import native_available  # noqa: E402

from torch_slice import (  # noqa: E402
    HIRES_STREAMS,
    check_card_layout,
    check_rows_engine,
    check_stream,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


@pytest.mark.parametrize("name", HIRES_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", HIRES_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("name", HIRES_STREAMS)
def test_card_layout_matches_jax(name, corpus):
    check_card_layout(name, corpus)
