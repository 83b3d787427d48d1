"""Peaks of the card the benchmark runs on: one NVIDIA H100 SXM5
(80 GB HBM3, 700 W), dense rates from NVIDIA's data sheet.

- HBM3 bandwidth: 3.35 TB/s.
- INT32 operations: 132 SMs x 64 INT32 lanes x 1.98 GHz (the card's
  highest SM clock, `nvidia-smi --query-gpu=clocks.max.sm` reads 1980
  MHz) = 16.73e12 instructions a second, and an IMAD, the multiply-add
  an LPC step is made of, counts as 2 operations: 33.45e12 op/s. (The
  67 TFLOP/s of float32 comes from 128 FP32 lanes an SM; the integer
  pipe has half as many lanes.)

A share of a peak is stated against these, beside the card's power
limit: a card set below 700 W reaches less of them.
"""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9 * 2
