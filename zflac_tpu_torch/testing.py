"""Deterministic PCM signal generators + corpus configurations for the
conformance suite (stands in for the ietf-wg-cellar corpus, which is an
empty submodule in the reference snapshot — SURVEY.md §4).

The port's copy of zflac_tpu/testing.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

import functools

import numpy as np

from .encoder import EncoderConfig, encode


def _clamp(x: np.ndarray, bps: int) -> np.ndarray:
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def tone_mix(n: int, channels: int, bps: int, seed: int = 0,
             noise: float = 0.02) -> np.ndarray:
    """Sum of per-channel sine partials + light noise: compresses well
    with LPC, exercises realistic residual statistics."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    amp = (1 << (bps - 1)) * 0.6
    freqs = rng.uniform(0.002, 0.18, size=(3, channels))
    phases = rng.uniform(0, 2 * np.pi, size=(3, channels))
    gains = rng.dirichlet(np.ones(3), size=channels).T
    x = sum(gains[i] * np.sin(2 * np.pi * freqs[i] * t + phases[i])
            for i in range(3))
    x = amp * x + rng.normal(0, noise * amp, size=(n, channels))
    return _clamp(x, bps)


def correlated_stereo(n: int, bps: int, seed: int = 0) -> np.ndarray:
    """Highly L/R-correlated material: makes decorrelation modes win."""
    rng = np.random.default_rng(seed)
    base = tone_mix(n, 1, bps, seed=seed)[:, 0]
    diff = rng.normal(0, (1 << (bps - 1)) * 0.01, size=n)
    return _clamp(np.stack([base, base + diff], axis=1), bps)


def noise(n: int, channels: int, bps: int, seed: int = 0,
          scale: float = 0.9) -> np.ndarray:
    """Near-full-scale noise: verbatim/escape territory."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, channels)) * (1 << (bps - 1)) * scale
    return _clamp(x, bps)


def silence_and_steps(n: int, channels: int, bps: int,
                      seed: int = 0) -> np.ndarray:
    """Piecewise-constant segments (constant subframes) + silence."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, channels), dtype=np.int64)
    pos = 0
    while pos < n:
        seg = int(rng.integers(200, 1200))
        level = int(rng.integers(-(1 << (bps - 2)), 1 << (bps - 2)))
        if rng.random() < 0.3:
            level = 0
        x[pos:pos + seg] = level
        pos += seg
    return x


def wasted_bits_signal(n: int, channels: int, bps: int, wasted: int = 4,
                       seed: int = 0) -> np.ndarray:
    """Signal whose low `wasted` bits are zero (e.g. 12-bit material in a
    16-bit container) -> encoder emits wasted-bits subframes."""
    x = tone_mix(n, channels, bps - wasted, seed=seed)
    return x << wasted


def ramps(n: int, channels: int, bps: int, seed: int = 0) -> np.ndarray:
    """Linear / quadratic ramps: fixed predictors win exactly."""
    t = np.arange(n, dtype=np.int64)
    amp = 1 << (bps - 2)
    cols = []
    for c in range(channels):
        if c % 3 == 0:
            y = (t * amp // max(n, 1)) - amp // 2
        elif c % 3 == 1:
            y = ((t * t) % (2 * amp)) - amp
        else:
            y = ((7919 * t) % (2 * amp)) - amp
        cols.append(y)
    return _clamp(np.stack(cols, axis=1), bps)


@functools.lru_cache(maxsize=1)
def make_corpus() -> dict[str, tuple[bytes, np.ndarray, int, int]]:
    """The synthesized conformance corpus: name -> (flac_bytes, pcm,
    sample_rate, bps). Mirrors the reference corpus's coverage axes
    (the reference's tests/std_subset.zig: blocksizes, bit depths,
    stereo modes, predictor types, partition extremes)."""
    corpus = {}

    def add(name, pcm, sr, bps, cfg):
        corpus[name] = (encode(pcm, sr, bps, cfg), pcm, sr, bps)

    # Block sizes (subset files 01-10). 576 and 1152 pad to 640/1152 —
    # 128-multiples NOT divisible by 512, pinning the LPC kernels' time
    # tile to gcd(Bp, 512) (ADVICE r4: min(512, Bp) crashed on these).
    for bsz in (16, 192, 254, 512, 576, 725, 1000, 1152, 1937, 2304,
                4096, 4608):
        add(f"blocksize {bsz}",
            tone_mix(3 * bsz + bsz // 3, 2, 16, seed=bsz), 44100, 16,
            EncoderConfig(block_size=bsz))
    # Bit depths (subset 11-14 and uncommon 15/20/24/32-bit).
    for bps in (8, 12, 16, 20, 24, 32):
        add(f"bps {bps}", tone_mix(9000, 2, bps, seed=bps), 44100, bps,
            EncoderConfig(block_size=2048))
    # Channels 1-8 (subset 15-22).
    for ch in range(1, 9):
        add(f"channels {ch}", tone_mix(6000, ch, 16, seed=100 + ch),
            48000, 16, EncoderConfig(block_size=1024))
    # Stereo decorrelation sweep (BASELINE.json config 3).
    for mode in ("independent", "left_side", "side_right", "mid_side"):
        add(f"stereo {mode}", correlated_stereo(8000, 16, seed=7),
            44100, 16, EncoderConfig(block_size=2048, stereo_mode=mode))
    # Subframe types.
    add("constant heavy", silence_and_steps(8192, 2, 16, seed=3),
        44100, 16, EncoderConfig(block_size=1024))
    add("verbatim noise", noise(4096, 2, 16, seed=4), 44100, 16,
        EncoderConfig(block_size=512, subframe_mode="verbatim"))
    for k in (0, 1, 2, 3, 4):
        add(f"fixed order {k}", ramps(6000, 2, 16, seed=5), 44100, 16,
            EncoderConfig(block_size=1024, subframe_mode=("fixed", k)))
    for k in (1, 2, 8, 16, 32):
        add(f"lpc order {k}", tone_mix(6000, 2, 16, seed=6 + k),
            44100, 16, EncoderConfig(block_size=1024,
                                     subframe_mode=("lpc", k)))
    # Rice coding extremes (subset 31-32: escapes, partition orders).
    add("partition order 0", tone_mix(4096, 2, 16, seed=9), 44100, 16,
        EncoderConfig(block_size=512, partition_order=0))
    add("partition order 8", tone_mix(2 * 4096, 2, 16, seed=10), 44100, 16,
        EncoderConfig(block_size=4096, partition_order=8))
    add("escaped partitions", noise(4096, 2, 16, seed=11), 44100, 16,
        EncoderConfig(block_size=1024, force_escape=True))
    # Coefficient precision sweep: 15 matches libflac defaults; 8 takes
    # the narrow-accumulator fast paths.
    add("lpc precision 15", tone_mix(6000, 2, 16, seed=24), 44100, 16,
        EncoderConfig(block_size=1024, subframe_mode=("lpc", 12),
                      lpc_precision=15))
    add("lpc precision 8", tone_mix(6000, 2, 16, seed=25), 44100, 16,
        EncoderConfig(block_size=1024, subframe_mode=("lpc", 8),
                      lpc_precision=8))
    add("rice2", noise(4096, 2, 24, seed=12, scale=0.99), 96000, 24,
        EncoderConfig(block_size=1024, coding_method=1))
    # Wasted bits (subset 53-54).
    add("wasted bits", wasted_bits_signal(6000, 2, 16, wasted=4, seed=13),
        44100, 16, EncoderConfig(block_size=1024))
    add("wasted bits 12of16", wasted_bits_signal(4000, 1, 16, wasted=8,
                                                 seed=14),
        44100, 16, EncoderConfig(block_size=512))
    # Blocking strategies / headers (subset 24-27, 33-34).
    add("variable blocksize", tone_mix(10000, 2, 16, seed=15), 44100, 16,
        EncoderConfig(block_size=2048, variable_blocking=True))
    add("uncommon blocksize", tone_mix(5000, 2, 16, seed=16), 44100, 16,
        EncoderConfig(block_size=1021, uncommon_block_size=True))
    add("uncommon samplerate", tone_mix(5000, 2, 16, seed=17), 44100 // 2,
        16, EncoderConfig(block_size=1024, uncommon_sample_rate=True))
    add("samplerate 192k", tone_mix(8000, 2, 24, seed=18), 192000, 24,
        EncoderConfig(block_size=4096))
    add("bps from streaminfo", tone_mix(4000, 2, 16, seed=19), 44100, 16,
        EncoderConfig(block_size=1024, bps_from_streaminfo=True))
    # Unknown / wrong total-sample metadata (zflac.zig:394-402 growth).
    add("unknown length", tone_mix(7000, 2, 16, seed=20), 44100, 16,
        EncoderConfig(block_size=1024, omit_total_samples=True))
    # High-res configs (BASELINE.json config 4).
    add("hi-res 24/96", tone_mix(12000, 2, 24, seed=21), 96000, 24,
        EncoderConfig(block_size=4096))
    add("hi-res 32bit", tone_mix(8000, 2, 32, seed=22), 48000, 32,
        EncoderConfig(block_size=2048))
    # 32-bit + decorrelation: 33-bit side subframes, the wide (hi/lo
    # pair) device path (zflac.zig:314-319 i64 InterType domain).
    add("hi-res 32bit mid_side", correlated_stereo(8000, 32, seed=26),
        48000, 32, EncoderConfig(block_size=2048,
                                 stereo_mode="mid_side"))
    add("hi-res 32bit left_side", correlated_stereo(6000, 32, seed=27),
        48000, 32, EncoderConfig(block_size=1024,
                                 stereo_mode="left_side"))
    add("surround 8ch 24bit", tone_mix(6000, 8, 24, seed=23), 48000, 24,
        EncoderConfig(block_size=1024))
    return corpus
