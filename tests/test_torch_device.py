"""The PyTorch port's pack2 device decode (zflac_tpu_torch) against the
JAX package's, end to end on the CPU: each corpus stream decodes to
the same PCM (tolerance zero). This file takes the streams that
exercise subframe types and their parameters;
test_torch_stream_format.py, test_torch_blocking.py,
test_torch_hires.py and test_torch_channels.py take the rest of the
corpus (tests/torch_slice.py). On the CPU every kernel wrapper
runs its plain PyTorch version; the CUDA kernels are held to those on
the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

from zflac_tpu.index.native_indexer import native_available  # noqa: E402
from zflac_tpu.testing import make_corpus  # noqa: E402

from torch_slice import (  # noqa: E402
    ALL_STREAMS,
    BLOCKING_STREAMS,
    CHANNEL_STREAMS,
    FORMAT_STREAMS,
    HIRES_STREAMS,
    SUBFRAME_STREAMS,
    check_card_layout,
    check_rows_engine,
    check_stream,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def test_stream_groups_cover_the_slice():
    """The five stream groups are the corpus, each stream once: the port
    takes every stream the JAX package's decode_to_device takes."""
    groups = (SUBFRAME_STREAMS + FORMAT_STREAMS + BLOCKING_STREAMS +
              HIRES_STREAMS + CHANNEL_STREAMS)
    assert groups == ALL_STREAMS
    assert len(set(groups)) == len(groups) == 61
    assert set(groups) == set(make_corpus())


@pytest.mark.parametrize("name", SUBFRAME_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)


@pytest.mark.parametrize("name", SUBFRAME_STREAMS)
def test_rows_engine_matches_jax(name, corpus):
    check_rows_engine(name, corpus)


@pytest.mark.parametrize("name", SUBFRAME_STREAMS)
def test_card_layout_matches_jax(name, corpus):
    check_card_layout(name, corpus)
