"""The scoped debug lines of the PyTorch port's rows-engine decode
(zflac_tpu_torch.runtime.decode) against the JAX package's
(zflac_tpu.runtime.decode), on the CPU: with the `stream`, `frame` and
`kernel` loggers at DEBUG, both packages' decode of one corpus stream
write the same messages in the same order, loggers zflac_tpu_torch.*
against zflac_tpu.*; the host C++ engine ("native" in both) writes
the same stream line; with the scopes off, the port writes no record."""

import logging

import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import zflac_tpu  # noqa: E402
from zflac_tpu.index.native_indexer import native_available  # noqa: E402

import zflac_tpu_torch  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

SCOPES = ("stream", "frame", "kernel")


def _lines(caplog, package: str, decode, level=logging.DEBUG) -> list:
    """(scope, message) of every record `decode()` makes under
    `package`'s loggers, with the three scopes at `level`."""
    for scope in SCOPES:
        caplog.set_level(level, logger=f"{package}.{scope}")
    caplog.clear()
    decode()
    prefix = package + "."
    return [(r.name[len(prefix):], r.getMessage()) for r in caplog.records
            if r.name.startswith(prefix)]


def _jax_engine(engine: str) -> str:
    return "tpu" if engine == "torch" else engine


@pytest.mark.parametrize("name,engine,safe_lpc", [
    ("lpc order 8", "torch", False),
    ("variable blocksize", "torch", False),
    ("hi-res 24/96", "torch", False),
    ("surround 8ch 24bit", "torch", False),
    ("lpc order 8", "torch", True),
    ("lpc order 8", "native", False),
    ("hi-res 32bit mid_side", "native", False),
])
def test_decode_logs_match_jax(name, engine, safe_lpc, corpus, caplog):
    """The port's stream, frame and kernel lines equal the JAX
    package's, message for message: one stream line a decode, one frame
    line a frame and one kernel line with the path and the class sizes
    on the rows engine; the native engine's one stream line."""
    assert name in corpus, f"corpus case {name!r} missing"
    data = corpus[name][0]
    got = _lines(caplog, "zflac_tpu_torch", lambda: zflac_tpu_torch.decode(
        data, engine=engine, safe_lpc=safe_lpc, device="cpu"))
    want = _lines(caplog, "zflac_tpu", lambda: zflac_tpu.decode(
        data, engine=_jax_engine(engine), safe_lpc=safe_lpc))
    assert got == want
    scopes = [scope for scope, _ in got]
    if engine == "native":
        assert scopes == ["stream"]
    else:
        frames = zflac_tpu_torch.decode(data, engine=engine,
                                        device="cpu").stats["frames"]
        assert scopes == ["stream"] + ["frame"] * frames + ["kernel"]


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_decode_logs_nothing_with_the_scopes_off(engine, corpus, caplog):
    """With the three scopes above DEBUG the port's decode makes no
    record."""
    data = corpus["lpc order 8"][0]
    assert _lines(caplog, "zflac_tpu_torch", lambda: zflac_tpu_torch.decode(
        data, engine=engine, device="cpu"), level=logging.INFO) == []
