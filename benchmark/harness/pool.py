"""A cell's inputs, made from the seed: the pool of streams that the
closed loop decodes, and the order in which it calls them.

The traffic file fixes the lengths: the pool holds one stream at the
midpoint of each of `pool` equal-probability slices of the length
distribution, so every seed decodes the same set of lengths. The seed
draws the signal of each stream, the order of the calls, and which
occurrence of each stream is checked.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import flacenc, signals


@dataclass
class Item:
    """One stream of the pool: its bytes, the PCM it was made from
    (host, int16 [n, channels]), the encoder's side information (for
    the reference) and the counts of its content (for the roofline
    files)."""
    data: bytes
    pcm: np.ndarray
    side: flacenc.Side

    @property
    def counts(self) -> dict:
        return self.side.counts

    @property
    def samples(self) -> int:
        """PCM samples of all channels."""
        return int(self.pcm.size)


def _quantiles(spec: dict, k: int) -> np.ndarray:
    """Midpoints of k equal-probability slices of the distribution
    `spec` ("uniform" or "beta" on [lo, hi])."""
    q = (np.arange(k) + 0.5) / k
    lo, hi = spec["lo"], spec["hi"]
    if spec["kind"] == "uniform":
        u = q
    elif spec["kind"] == "beta":
        x = np.linspace(0.0, 1.0, 200001)
        pdf = x ** (spec["a"] - 1) * (1 - x) ** (spec["b"] - 1)
        cdf = np.cumsum(pdf)
        cdf /= cdf[-1]
        u = np.interp(q, cdf, x)
    else:
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    return lo + (hi - lo) * u


def lengths(traffic: dict, sample_rate: int) -> list:
    """Samples a channel of each stream of the pool."""
    secs = _quantiles(traffic["lengths_s"], traffic["pool"])
    return [int(round(s * sample_rate)) for s in secs]


def _seed(seed: int, *salt: int) -> int:
    return int(np.random.SeedSequence([seed, *salt]).generate_state(
        1, np.uint64)[0])


def build(config: dict, traffic: dict, seed: int, device) -> list:
    """The pool's streams, made on `device` from the seed."""
    fmt = config["format"]
    pcms = [signals.make(n, fmt, config["signal"],
                         signals.generator(_seed(seed, 1, i), device), device)
            for i, n in enumerate(lengths(traffic, fmt["sample_rate"]))]
    streams = flacenc.encode_pool(pcms, fmt, config["encoder"],
                                  config["metadata"])
    items = [Item(data=data, pcm=pcm.cpu().numpy(), side=side)
             for pcm, (data, side) in zip(pcms, streams)]
    del pcms, streams
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return items


class Schedule:
    """The closed loop's order: rounds through the pool, each in a new
    permutation drawn from the seed; and for each stream the occurrence
    (0 .. within-1) whose output is checked."""

    def __init__(self, seed: int, pool: int, within: int):
        self._rng = np.random.default_rng(_seed(seed, 2))
        self.pool = pool
        self.check_at = self._rng.integers(0, within, size=pool)
        self._round = []

    def next(self) -> int:
        if not self._round:
            self._round = list(self._rng.permutation(self.pool))
        return int(self._round.pop())
