"""Multi-GPU / multi-process scaling: frame-parallel decode over a list
of torch devices (counterpart of zflac_tpu/parallel).

Frames are sharded across devices (shard.py), long streams across byte
ranges at frame granularity with a boundary-offset exchange
(longstream.py), and across processes over torch.distributed
(distributed.py).
"""

from .shard import make_mesh, reconstruct_sharded  # noqa: F401
