"""zflac_tpu_torch — the pack2 device decode of zflac_tpu in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

`decode_to_device(data, device=...)` turns FLAC bytes into PCM in
device memory, for every stream zflac_tpu's decode_to_device takes
(1-8 channels, 8-32 bits, 33-bit side channels): the host C++ scan
shared with zflac_tpu writes one int32 plan buffer per chunk, and the
device reconstructs it through the rice16, lpc2, lpc2w, lpc2w33 and
packtail kernels (csrc/). On CPU tensors each kernel wrapper runs its
plain PyTorch version, which the tests hold bit-exact to the JAX
package.

This package imports torch and never jax; of zflac_tpu it uses only
the jax-free host modules (format, errors, result, bitio, oracle,
index.native_indexer, encoder, testing).
"""

from .runtime.device import DeviceDecoded, decode_to_device  # noqa: F401

__version__ = "0.1.0"
