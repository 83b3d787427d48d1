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
1024. bench16 at TRACK_SAMPLES (bench16_track: a 3 min 30 s track,
2261 frames) is the stream whose decode_to_device ranges are not near
a power of two: its 8 parallel-scan chunks hold 282-283 frames, which
the JAX package's layout pads to 512.
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
# bench16's signal at a 3 min 30 s track's length at 44.1 kHz
# (bench_stream("bench16", TRACK_SAMPLES)): 2260 whole frames and one
# of 4040 samples.
TRACK_SAMPLES = 210 * 44100
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


def three_class_stream() -> bytes:
    """A short stream (7 frames, bench16's signal, block 1024) whose one
    chunk holds three classes: its first two frames are silent
    (constant subframes), the last holds 10 samples (fixed order 2:
    too short for the encoder's LPC) and the rest are LPC. In the card
    layout the class blocks start at lanes 0, 32 and 64, so the LPC
    kernels read a lane slice that starts at lane 64."""
    pcm = correlated_stereo(6 * 1024 + 10, 16, seed=7)
    pcm[:2 * 1024] = 0
    return encode(pcm, 44100, 16, EncoderConfig(block_size=1024))


def first_chunk(data: bytes):
    """The whole stream as one pack2 chunk, in the card layout that
    decode_to_device reconstructs."""
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=1 << 20, layout="card")
    if ck is None:
        raise RuntimeError("pack2 scan declined the stream")
    return ck
