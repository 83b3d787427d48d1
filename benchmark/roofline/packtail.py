"""packtail (csrc/packtail.cu, `packtail_kernel`): stereo subframes to
interleaved container PCM (stream order, wasted bits, decorrelation).
Least work: every subframe sample read once at its width (16 bits, 17
for a side channel), every PCM sample written once at the container's
width."""

KERNEL = r"packtail_kernel<\d+>"


def work(c: dict):
    out = c["samples"] * c["channels"] * c["container_bytes"]
    return c["sample_bits"] / 8 + out, 0.0
