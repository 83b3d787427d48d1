"""lpc (csrc/lpc.cu, `lpc_kernel<int>`): the rows engine's LPC
recursion at int32. Least work as lpc2's: each residual read once as a
32-bit integer, each sample written once at its subframe's width, an
IMAD (2 operations) per coefficient and an add and a shift per sample."""

KERNEL = r"lpc_kernel<int>"


def work(c: dict):
    bytes_ = 4 * c["lpc_residuals"] + c["lpc_sample_bits"] / 8
    return bytes_, 2 * c["lpc_macs"] + 2 * c["lpc_residuals"]
