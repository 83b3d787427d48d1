"""packtail_roofline: the packtail kernel's share of its roofline over the
traced window, its least work counted from the streams' content
(roofline/packtail.py) over its summed time in the trace."""

from harness.roofline import kernel_share


def read(run):
    return kernel_share(run, "packtail")
