"""Build both packages' host scan libraries once, before pytest-xdist
starts its workers.

The JAX package builds libzflac_index.so in place at first use, under
a thread lock only (zflac_tpu/index/native_indexer.py `_load`). On a
checkout without the library, the workers of `-n 6` would each start
g++ on the same output path, and a worker that loads a half-written
file marks the native indexer unavailable for its whole life: its
native tests then skip or fail. Built here, in the controller, the
library is fresh when the workers start, and they only load it. The
port's scan library builds under a lock and through a rename, so its
build is only moved ahead for the same reason: one build, not one per
worker.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from zflac_tpu.index import native_indexer as jax_side
    from zflac_tpu_torch.index import native_indexer as port_side

    jax_side.native_available()
    port_side.native_available()
