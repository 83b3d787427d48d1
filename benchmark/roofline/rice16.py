"""rice16 (csrc/rice16.cu, `rice16_rows_kernel`): the Rice-coded
residuals of every fixed and LPC subframe out of the bitstream.
Least work: the residual sections' bits read once (parameters and
codes), each residual written once as a 32-bit integer (RFC 9639
9.2.7.1: residuals fit in 32 signed bits). Its integer work, a few
operations a residual, is far under the bytes' time and not counted."""

KERNEL = r"rice16_rows_kernel<\d+>"


def work(c: dict):
    return c["rice_bits"] / 8 + 4 * c["rice_residuals"], 0.0
