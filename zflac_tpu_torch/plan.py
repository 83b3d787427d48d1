"""Decode plan: the structure-of-arrays *frame table* that the host
indexer emits and the TPU kernels consume.

This is the load-bearing interface of the two-phase design (SURVEY.md
§7): phase 1 (serial host scan of the bitstream) produces the plan;
phase 2 (batched XLA/Pallas reconstruction) is pure dataflow over these
dense arrays — no Python control flow per sample.

Array conventions (S = total subframes = frames x channels, B = padded
max block size, index s = frame * channels + channel):

  rows[S, B]      warmup-seeded residual rows: positions < order hold the
                  unencoded warm-up samples, positions order..block hold
                  decoded residuals; verbatim rows hold raw samples;
                  constant rows hold the constant at position 0.
  kind[S]         0 constant / 1 verbatim / 2 fixed / 3 LPC
                  (subframe type codes, zflac.zig:175-185)
  order[S]        predictor order (0-4 fixed, 1-32 LPC)
  wasted[S]       wasted-bits shift (zflac.zig:433)
  shift[S]        LPC prediction right shift (zflac.zig:510)
  coeffs_rev[S,32] quantized LPC coefficients, reversed so that slot
                  31-j multiplies s[i-1-j] (mirrors zflac.zig:513's
                  memory-order layout)
  fixed_seeds[S,4] finite-difference seeds Delta^j s[j] of the warm-ups,
                  which turn fixed-order reconstruction into j cumsums
                  (SURVEY.md §7 fact 2)
  wide[S]         LPC accumulator needs > 32 bits (libflac-style
                  predicate: bps + precision + log2(order))

Frame-level arrays (F = frames):

  block_size[F], channel_code[F], pcm_start[F] (per-channel sample
  offset of the frame), frame_byte_offset[F] (seek table / resume).

The port's copy of zflac_tpu/plan.py, held equal to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .format import StreamInfo, container_bits


def stream_dtype(bits_per_sample: int):
    """Residual/sample compute dtype for a stream. Containers up to 16
    bits fit int32 end-to-end (residuals <= bps+1+order+1 < 32 bits);
    24/32-bit streams use int64 like the reference's i64 InterType
    (zflac.zig:314-319)."""
    return np.int32 if container_bits(bits_per_sample) <= 16 else np.int64


@dataclass
class StreamPlan:
    info: StreamInfo
    # Locked stream parameters from the first frame (zflac.zig:376-392).
    sample_rate: int
    channels: int
    bits_per_sample: int

    # frame-level
    block_size: np.ndarray        # [F] i32
    channel_code: np.ndarray      # [F] i32
    pcm_start: np.ndarray         # [F] i64 per-channel sample offset
    frame_byte_offset: np.ndarray  # [F] i64
    coded_number: np.ndarray      # [F] i64 (frame idx / first sample)

    # subframe-level
    rows: np.ndarray | None       # [S, B] stream dtype (None: skim plan)
    kind: np.ndarray              # [S] i32
    order: np.ndarray             # [S] i32
    wasted: np.ndarray            # [S] i32
    shift: np.ndarray             # [S] i32
    coeffs_rev: np.ndarray        # [S, 32] i32
    fixed_seeds: np.ndarray       # [S, 4] stream dtype
    wide: np.ndarray              # [S] bool

    total_samples: int            # per-channel, actual decoded
    variable_blocking: bool = False
    stats: dict = field(default_factory=dict)
    #: Optional Rice-group offset table (native indexer emit_groups=True)
    #: for the TPU bit-unpack kernel: {"off": [S, GPB] i64 absolute bit
    #: offsets (-1 invalid), "k": [S, GPB] u8 (0xFE escape, 0xFF host
    #: fallback), "depth": [S, GPB] u8}. Groups cover G=8 output
    #: positions.
    groups: dict | None = None
    #: Skim plan (measure-only native index, zfi_index_skim): rows is
    #: None; the accelerator recomputes residuals from `groups` and the
    #: bitstream. warmups[S, 32] holds warm-up/constant values; patches
    #: = (sub, pos, val) int32 arrays for positions the unpack kernel
    #: cannot produce (invalid groups, misaligned partition layouts,
    #: verbatim subframes, short tails).
    warmups: np.ndarray | None = None
    patches: tuple | None = None
    max_block_v: int = 0          # explicit B when rows is None

    @property
    def num_frames(self) -> int:
        return len(self.block_size)

    @property
    def num_subframes(self) -> int:
        return len(self.kind)

    @property
    def max_block(self) -> int:
        return self.rows.shape[1] if self.rows is not None \
            else self.max_block_v

    def classes(self) -> dict[str, np.ndarray]:
        """Subframe indices per kernel class (gather lists for the
        batched reconstruction)."""
        kind = self.kind
        wide = self.wide
        return {
            "const": np.nonzero(kind == 0)[0],
            "verbatim": np.nonzero(kind == 1)[0],
            "fixed": np.nonzero(kind == 2)[0],
            "lpc": np.nonzero((kind == 3) & ~wide)[0],
            "lpc_wide": np.nonzero((kind == 3) & wide)[0],
        }


#: Fixed-predictor warm-up finite-difference coefficient triangle:
#: seeds[j] = Delta^j s[j] = sum_i TRIANGLE[j][i] * w[i].
SEED_TRIANGLE = (
    (1,),
    (-1, 1),
    (1, -2, 1),
    (-1, 3, -3, 1),
)


def fixed_seeds_from_warmup(warmup, order: int, dtype) -> np.ndarray:
    """Delta^j s[j] for j < order (host-side, <= 4 values)."""
    out = np.zeros(4, dtype=dtype)
    for j in range(order):
        acc = 0
        for i, c in enumerate(SEED_TRIANGLE[j]):
            acc += c * int(warmup[i])
        out[j] = acc
    return out
