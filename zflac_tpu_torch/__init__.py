"""zflac_tpu_torch — zflac_tpu's decode in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

Two engines, as in the JAX package:
- `decode_to_device(data)`, the pack2 path, turns FLAC bytes into PCM
  in device memory for every stream zflac_tpu's decode_to_device takes
  (1-8 channels, 8-32 bits, 33-bit side channels): the host C++ scan
  (index/) writes one int32 plan buffer per chunk, and the device
  reconstructs it through the rice16, lpc2, lpc2w, lpc2w33 and
  packtail kernels (csrc/).
- the rows engine, `decode(data)` (engine="torch", the default) and
  its `decode_pipelined`, `stream_decode`, `decode_range` and
  `decode_tolerant`: the host indexer builds a dense plan, the device
  reconstructs it through the lpc (int32) and lpc64 kernels, and the
  PCM is assembled on the host into a DecodedFLAC, MD5 checked.
  `engine="native"` is the host C++ engine, taken only when asked for.

Every entry point runs on the card, device="cuda", unless the caller
passes device="cpu" (or "cuda:N"); with no card a CUDA request raises.
On CPU tensors each kernel wrapper runs its plain PyTorch version,
which the tests hold bit-exact to the JAX package.

`zflac_tpu_torch.parallel` spreads both engines over several cards and
processes (frame-sharded decode over a list of devices, long streams
split at frame anchors, multi-process decode over torch.distributed),
and `python -m zflac_tpu_torch.cli` is the command line.

This package imports torch, and neither jax nor zflac_tpu: it keeps
its own copies of the JAX package's host modules (format, bitio,
errors, crc, result, plan, metadata, oracle, index with the C++ scan
sources, utils.log, and encoder and testing for chip_smoke.py).
"""

from . import format  # noqa: F401
from .errors import (  # noqa: F401
    EndOfStream,
    FlacError,
    InconsistentParameters,
    InvalidChecksum,
    InvalidCodedNumber,
    InvalidFrameHeader,
    InvalidMetadataHeader,
    InvalidResidualCodingMethod,
    InvalidSignature,
    InvalidSubframeHeader,
    MissingStreaminfo,
    Unimplemented,
)
from .result import DecodedFLAC  # noqa: F401
from .runtime.device import DeviceDecoded  # noqa: F401

__version__ = "0.1.0"


def _read(data) -> bytes:
    """Bytes, or the contents of the file at path `data`."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return bytes(data)


def decode_to_device(data, **kwargs):
    """Decode a FLAC stream (bytes or path) to PCM in device memory,
    the pack2 path (runtime/device.py; device="cuda" unless told
    otherwise). Returns a DeviceDecoded, or None where the pack2 path
    declines the stream."""
    from .runtime.device import decode_to_device as _dd
    return _dd(_read(data), **kwargs)


def decode(data, **kwargs):
    """Decode a FLAC stream (bytes or path) to PCM
    (runtime/decode.py; the default engine, "torch", runs on
    device="cuda" unless told otherwise)."""
    from .runtime.decode import decode as _decode
    return _decode(_read(data), **kwargs)


def decode_range(data, start_sample, num_samples, **kwargs):
    """Partial decode of [start_sample, start_sample + num_samples) on
    the device (runtime/seek.py)."""
    from .runtime.seek import decode_range as _dr
    return _dr(_read(data), start_sample, num_samples, **kwargs)


def decode_tolerant(data, **kwargs):
    """Error-recovering decode on the device: resynchronize past corrupt
    regions; gaps become silence at exact sample positions
    (runtime/seek.py)."""
    from .runtime.seek import decode_tolerant as _dt
    return _dt(_read(data), **kwargs)


def decode_pipelined(data, **kwargs):
    """Chunked decode on the device, overlapping host indexing with
    device work (runtime/decode.py)."""
    from .runtime.decode import decode_pipelined as _dp
    return _dp(_read(data), **kwargs)


def stream_decode(data, **kwargs):
    """Generator of PCM chunks as they decode on the device
    (runtime/decode.py)."""
    from .runtime.decode import stream_decode as _sd
    return _sd(_read(data), **kwargs)


def decode_oracle(data, **kwargs):
    """Decode with the pure-Python scalar oracle (slow; testing)."""
    from .oracle import decode as _decode
    return _decode(_read(data), **kwargs)


def probe(data):
    """Parse stream metadata (tags, seek table, pictures) without
    decoding audio (metadata.py)."""
    from .metadata import probe as _probe
    return _probe(_read(data))
