"""lpc2 (csrc/lpc2.cu, `lpc2_kernel`): the LPC recursion of every LPC
subframe of a pack2 chunk in an 8/16-bit container. Least work: each
residual read once as a 32-bit integer, each sample written once at its
subframe's width (16 bits, 17 for a side channel); an IMAD (2
operations) per coefficient and an add and a shift per predicted
sample."""

KERNEL = r"lpc2_kernel<\d+>"


def work(c: dict):
    bytes_ = 4 * c["lpc_residuals"] + c["lpc_sample_bits"] / 8
    return bytes_, 2 * c["lpc_macs"] + 2 * c["lpc_residuals"]
