"""The PyTorch port's pack2 device decode (zflac_tpu_torch) against the
JAX package's, end to end on the CPU: each stereo corpus stream of
<= 16 bits decodes to the same PCM (tolerance zero). This file takes
the streams that exercise subframe types and their parameters;
test_torch_stream_format.py and test_torch_blocking.py take the rest
of the slice (tests/torch_slice.py). On the CPU every kernel wrapper
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
    BLOCKING_STREAMS,
    FORMAT_STREAMS,
    SUBFRAME_STREAMS,
    check_stream,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")


def test_stream_groups_cover_the_slice():
    """The three stream groups are the slice's streams, each once: every
    corpus stream with two channels and at most 16 bits."""
    groups = SUBFRAME_STREAMS + FORMAT_STREAMS + BLOCKING_STREAMS
    assert len(set(groups)) == len(groups)
    assert set(groups) == {
        name for name, (_d, pcm, _sr, bps) in make_corpus().items()
        if pcm.shape[1] == 2 and bps <= 16}


@pytest.mark.parametrize("name", SUBFRAME_STREAMS)
def test_slice_matches_jax(name, corpus):
    check_stream(name, corpus)
