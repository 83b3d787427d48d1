"""lpc_roofline: the lpc kernel's share of its roofline over the
traced window, its least work counted from the streams' content
(roofline/lpc.py) over its summed time in the trace."""

from harness.roofline import kernel_share


def read(run):
    return kernel_share(run, "lpc")
