"""The PyTorch port's decode_to_device (zflac_tpu_torch) against the JAX
package's on the CPU, for the corpus streams with other than two
channels (1 and 3-8, in the 16-bit and 32-bit containers, with wasted
bits): the general tail of row gather, wasted shift, transpose and
container cast. Tolerance zero."""

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

from zflac_tpu.index.native_indexer import native_available  # noqa: E402

from torch_slice import (  # noqa: E402
    CHANNEL_STREAMS,
    check_card_layout,
    check_rows_engine,
    check_stream,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


@pytest.mark.parametrize("name", CHANNEL_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", CHANNEL_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("name", CHANNEL_STREAMS)
def test_card_layout_matches_jax(name, corpus):
    check_card_layout(name, corpus)
