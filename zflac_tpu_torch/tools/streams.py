"""The bench streams the port's tools and chip_smoke.py decode, each
encoded once from a seed and cached in .bench_cache/ at the checkout's
root: correlated stereo, block 4096, 44.1 kHz.

  bench16    bench.py's stream: 2**22 samples a channel at 16 bits;
  bench24    the JAX package's stream24 row (tools/bench_tpu.py):
             2**21 samples at 24 bits;
  bench32ms  2**20 samples at 32 bits, mid-side, whose 33-bit side
             channels make wide chunks.

`samples` overrides a stream's length (the CPU tests run the tools at
2**14); the cache file's name carries the length, bits and stereo mode.
bench16 at ODD_SAMPLES (513 frames, one past a power of two) is the
rows engine's stream whose frame axis the JAX package would pad to
1024.
"""

from __future__ import annotations

import os

import numpy as np

from ..bitio import BitReader
from ..encoder import EncoderConfig, encode
from ..index.native_indexer import pack2_range
from ..oracle import parse_metadata
from ..testing import correlated_stereo

BENCH_BLOCK = 4096
# name -> (samples per channel, bits per sample, stereo mode, the
# kernels its decode_to_device path must launch).
BENCH = {
    "bench16": (1 << 22, 16, None, ("rice16", "lpc2", "packtail")),
    "bench24": (1 << 21, 24, None, ("rice16", "lpc2w")),
    "bench32ms": (1 << 20, 32, "mid_side", ("rice16", "lpc2w33")),
}
# bench16's length cut to 513 frames (bench_stream("bench16",
# ODD_SAMPLES)).
ODD_SAMPLES = 513 * BENCH_BLOCK
# The bench stream of each bit depth.
BY_BPS = {16: "bench16", 24: "bench24", 32: "bench32ms"}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, ".bench_cache")


def bench_pcm(name: str, samples: int = None) -> np.ndarray:
    n, bps, _, _ = BENCH[name]
    return correlated_stereo(samples or n, bps, seed=7)


def bench_path(name: str, samples: int = None) -> str:
    n, bps, mode, _ = BENCH[name]
    return os.path.join(
        CACHE, f"bench_{samples or n}_{bps}bit_{BENCH_BLOCK}"
        f"{'_' + mode if mode else ''}.flac")


def bench_stream(name: str, samples: int = None) -> bytes:
    """Bench stream `name`, from its cache file when present, else
    encoded and cached."""
    _, bps, mode, _ = BENCH[name]
    path = bench_path(name, samples)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    cfg = EncoderConfig(block_size=BENCH_BLOCK,
                        **({"stereo_mode": mode} if mode else {}))
    data = encode(bench_pcm(name, samples), 44100, bps, cfg)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return data


def first_chunk(data: bytes):
    """The whole stream as one pack2 chunk."""
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 20)
    if ck is None:
        raise RuntimeError("pack2 scan declined the stream")
    return ck
