"""The PyTorch port's pack2 runtime (zflac_tpu_torch.runtime.device)
piece by piece, on the CPU: the stages between the kernels equal the
JAX core truncated at the same point, the buffer upload round-trips,
the stop cut, corruption and out-of-slice streams behave as in the JAX
package, the kernel wrappers never fall back from a CUDA request to the
CPU, and the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The tensors here are tiny: intra-op threads would only contend with
# the other test worker processes (and stall under that contention).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zflac_tpu.errors import InvalidChecksum  # noqa: E402
from zflac_tpu.index.native_indexer import (  # noqa: E402
    native_available,
    pack2_range,
)

import zflac_tpu_torch  # noqa: E402
from zflac_tpu_torch import _kernels  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _first_chunk(data, **kw):
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info, **kw)
    assert ck is not None
    return ck


def test_apply_stop_cut():
    bs = [np.array([4, 4]), np.array([4, 4])]
    assert rt.apply_stop_cut(bs, 8) == (1, 0, 8)
    assert rt.apply_stop_cut(bs, 12) == (1, 1, 12)
    assert rt.apply_stop_cut(bs, 6) is None        # frame 1 crosses 6
    assert rt.apply_stop_cut(bs, 16) is None
    assert rt.apply_stop_cut(bs, 0) == (0, 0, 0)


def test_corruption_raises(corpus):
    """A flipped residual bit decodes but fails the stream MD5."""
    bad = bytearray(corpus["lpc order 8"][0])
    bad[-200] ^= 0x10
    dd = zflac_tpu_torch.decode_to_device(bytes(bad), device="cpu")
    assert dd is not None
    with pytest.raises(InvalidChecksum):
        dd.to_host()


@pytest.mark.parametrize("name", ["bps 24", "channels 1",
                                  "hi-res 32bit mid_side"])
def test_outside_slice_raises(name, corpus):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zflac_tpu_torch.decode_to_device(corpus[name][0], device="cpu")


@pytest.mark.parametrize("name", ["constant heavy", "verbatim noise",
                                  "fixed order 3", "lpc order 32",
                                  "escaped partitions", "bps 8"])
def test_stages_match_jax(name, corpus):
    """The port's stages equal the JAX core truncated at the same
    point: residual_rows == stage "rows", sorted_stack == stage
    "transpose", reconstruct_pack2 == the chunk PCM."""
    from zflac_tpu import format as fmt
    from zflac_tpu.runtime.device import _reconstruct_pack2_core

    ck = _first_chunk(corpus[name][0], max_frames=64, force_fp=64)
    cb = fmt.container_bits(ck.bits_per_sample)
    stages = ("rows", "transpose", "full")
    # One compile for the three truncations (XLA shares their prefix).
    want = jax.jit(lambda b: tuple(_reconstruct_pack2_core(
        b, spec=ck.spec_key(), num_channels=2, container_bits=cb,
        do_decorrelate=ck.do_decorrelate, use_pallas=False, stage=stage)
        for stage in stages))(jnp.asarray(ck.device_buf))
    want = dict(zip(stages, map(np.asarray, want)))

    buf, geom = rt.chunk_to_torch(ck, "cpu")
    rows_t = rt.residual_rows(buf, geom)
    np.testing.assert_array_equal(rows_t.numpy(), want["rows"])
    stack = rt.sorted_stack(rows_t, buf, geom)
    np.testing.assert_array_equal(stack.numpy(), want["transpose"])
    pcm = rt.reconstruct_pack2(buf, geom, container_bits=cb)
    np.testing.assert_array_equal(pcm.numpy(), want["full"])


def test_chunk_to_torch_round_trip(corpus):
    ck = _first_chunk(corpus["stereo mid_side"][0])
    buf, geom = rt.chunk_to_torch(ck, "cpu")
    assert buf.dtype == torch.int32 and buf.device.type == "cpu"
    np.testing.assert_array_equal(buf.numpy(), ck.device_buf)
    spec = ck.spec_key()
    assert (geom.Fp, geom.Sp, geom.Bp, geom.GPB, geom.W, geom.NGp,
            geom.n_patch_p, geom.C, geom.classes) == spec[:9]
    assert geom.off == dict(spec[9]) and geom.Ssort == ck.Ssort
    off = ck.off["inv"]
    np.testing.assert_array_equal(geom.sect(buf, "inv", geom.Sp).numpy(),
                                  ck.buf[off:off + ck.Sp])
    ck.buf[:] = 0                       # the upload is a copy
    assert buf.abs().sum() > 0


def test_port_imports_no_jax():
    """In a fresh interpreter the port and chip_smoke.py load without
    JAX (the card's machine has none)."""
    code = ("import sys\n"
            "import zflac_tpu_torch\n"
            "from zflac_tpu_torch.runtime import device, reconstruct\n"
            "from zflac_tpu_torch.ops import rice16, lpc2, packtail\n"
            "from zflac_tpu_torch import _kernels\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'jax']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_route_launches_nothing(corpus):
    _kernels.launches.clear()
    zflac_tpu_torch.decode_to_device(corpus["constant heavy"][0],
                                     device="cpu")
    assert sum(_kernels.launches.values()) == 0


def test_kernel_wrappers_refuse_other_devices():
    """The wrappers run the plain version only for CPU tensors: tensors
    elsewhere, or on several devices, raise instead of falling back."""
    from zflac_tpu_torch.ops.lpc2 import lpc2_reconstruct
    from zflac_tpu_torch.ops.packtail import packtail
    from zflac_tpu_torch.ops.rice16 import rice16_unpack_rows

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with pytest.raises(ValueError, match="device"):
        rice16_unpack_rows(meta(8, 1024), meta(1024), Ssort=1024)
    with pytest.raises(ValueError, match="several devices"):
        rice16_unpack_rows(torch.zeros((8, 1024), dtype=torch.int32),
                           meta(1024), Ssort=1024)
    with pytest.raises(ValueError, match="device"):
        lpc2_reconstruct(meta(128, 128), meta(8, 128), meta(128),
                         meta(128))
    with pytest.raises(ValueError, match="device"):
        packtail(meta(129, 128), meta(8), meta(8), meta(4), Fp=4,
                 container_bits=16)


def test_cuda_request_without_a_card_raises(corpus):
    """device="cuda" with no usable card raises: nothing moves to the
    CPU on its own, and the kernels cannot be built without nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        zflac_tpu_torch.decode_to_device(corpus["lpc order 8"][0],
                                         device="cuda")
    try:
        _kernels.find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _kernels.library()
