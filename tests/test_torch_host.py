"""The port's own copies of the JAX package's host modules
(zflac_tpu_torch: format, bitio, errors, oracle, plan, index with the
C++ scan, encoder, testing) against the originals, on the CPU: equal
metadata, plans from both indexers, pack2 buffers, encoder bytes and
native-decoder PCM on the corpus streams; the port imports nothing of
the JAX package; its error classes keep the JAX package's names and
hierarchy; and its scan library builds safely from two processes at
once."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zflac_tpu import errors as jerr  # noqa: E402
from zflac_tpu.bitio import BitReader as JBitReader  # noqa: E402
from zflac_tpu.index import build_plan_py as jbuild_plan_py  # noqa: E402
from zflac_tpu.index import native_indexer as jni  # noqa: E402
from zflac_tpu.oracle import parse_metadata as jparse  # noqa: E402

from zflac_tpu_torch import errors as perr  # noqa: E402
from zflac_tpu_torch import testing as ptesting  # noqa: E402
from zflac_tpu_torch.bitio import BitReader  # noqa: E402
from zflac_tpu_torch.encoder import EncoderConfig, encode  # noqa: E402
from zflac_tpu_torch.index import build_plan_py  # noqa: E402
from zflac_tpu_torch.index import native_indexer as ni  # noqa: E402
from zflac_tpu_torch.oracle import parse_metadata  # noqa: E402
from zflac_tpu_torch.runtime import device as rt  # noqa: E402

from torch_slice import ALL_STREAMS  # noqa: E402

pytestmark = pytest.mark.skipif(
    not jni.native_available(), reason="native indexer unavailable")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_equal(a, b, what=""):
    """Deep equality of plans, stream infos and their fields."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{what}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def _port_files():
    pkg = os.path.join(_REPO, "zflac_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(_REPO, "chip_smoke.py")


def test_port_source_imports_nothing_of_the_jax_package():
    """No `import zflac_tpu...`, `from zflac_tpu... import` or jax
    import statement in any file of the port or in chip_smoke.py."""
    bad = []
    files = list(_port_files())
    assert len(files) > 20
    rel = {os.path.relpath(f, os.path.join(_REPO, "zflac_tpu_torch"))
           for f in files}
    assert {"cli.py", os.path.join("utils", "timer.py"),
            os.path.join("utils", "profiler.py"),
            *(os.path.join("parallel", m + ".py") for m in
              ("__init__", "shard", "longstream", "distributed"))} <= rel
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, _REPO)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("zflac_tpu", "jax")]
    assert not bad, bad


def test_error_classes_keep_names_and_hierarchy():
    """Every exception class of zflac_tpu.errors has a port class of the
    same name whose bases carry the same names, and the port's classes
    are their own (catching one package's class does not catch the
    other's)."""
    classes = {n: c for n, c in vars(jerr).items()
               if isinstance(c, type) and issubclass(c, Exception)
               and c.__module__ == jerr.__name__}
    assert len(classes) >= 12
    for name, cls in classes.items():
        port = getattr(perr, name)
        assert port is not cls
        assert [b.__name__ for b in port.__mro__] == \
            [b.__name__ for b in cls.__mro__], name
    assert issubclass(perr.InvalidChecksum, perr.FlacError)
    assert not issubclass(perr.InvalidChecksum, jerr.FlacError)


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_parse_metadata_matches(name, corpus):
    data = corpus[name][0]
    jbr, br = JBitReader(data), BitReader(data)
    _assert_equal(parse_metadata(br), jparse(jbr), name)
    assert br.pos == jbr.pos


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_build_plan_matches(name, corpus):
    """The native and the Python indexer each give the same plan as the
    JAX package's."""
    data = corpus[name][0]
    _assert_equal(ni.build_plan_native(data, emit_groups=True),
                  jni.build_plan_native(data, emit_groups=True), name)
    _assert_equal(build_plan_py(data), jbuild_plan_py(data), name)


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_native_decode_matches(name, corpus):
    data = corpus[name][0]
    got, meta = ni.decode_cpu_native(data)
    want, jmeta = jni.decode_cpu_native(data)
    assert got.dtype == want.dtype and meta == jmeta
    np.testing.assert_array_equal(got, want)
    got, meta = ni.decode_native_parallel(data)
    want, jmeta = jni.decode_native_parallel(data)
    assert meta == jmeta
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_corpus_encodes_equal(name, corpus):
    """The port's make_corpus (its encoder and signal generators) gives
    the JAX package's bytes and PCM for every corpus stream."""
    data, pcm, sr, bps = ptesting.make_corpus()[name]
    jdata, jpcm, jsr, jbps = corpus[name]
    assert data == jdata and (sr, bps) == (jsr, jbps)
    np.testing.assert_array_equal(pcm, jpcm)


def _pack2_pair(data, start, stop, info, **kw):
    a = ni.pack2_range(data, start, stop, info, **kw)
    b = jni.pack2_range(data, start, stop, info, **kw)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a.device_buf, b.device_buf)
        assert a.spec_key() == b.spec_key() and a.landed == b.landed
        np.testing.assert_array_equal(a.f_block_size, b.f_block_size)
    return a


@pytest.mark.parametrize("name", ALL_STREAMS)
def test_pack2_matches(name, corpus):
    """The whole-stream pack2 chunk of every corpus stream."""
    data = corpus[name][0]
    br = BitReader(data)
    info = parse_metadata(br)
    _pack2_pair(data, br.pos // 8, len(data), info, max_frames=1 << 20)


@pytest.mark.parametrize("bps,mode", [(16, None), (24, None),
                                      (32, "mid_side")])
def test_pack2_bench_like_chunks_match(bps, mode):
    """The chunks decode_to_device scans from a short bench-like stream
    (correlated stereo, block 4096) in parallel ranges, each packed by
    both libraries with the natural and then the forced union geometry:
    equal buffers and geometry keys."""
    pcm = ptesting.correlated_stereo(1 << 16, bps, seed=7)
    data = encode(pcm, 44100, bps, EncoderConfig(
        block_size=4096, **({"stereo_mode": mode} if mode else {})))
    br = BitReader(data)
    info = parse_metadata(br)
    chunks = rt.scan_pack2_chunks(data, br.pos // 8, info, 4, 4096, False,
                                  workers=3)
    assert len(chunks) >= 3
    cnp, pnp, wide = rt.class_caps([ck for _, ck in chunks])
    for a, ck in chunks:
        kw = dict(max_frames=4, force_fp=4, force_bp=4096)
        assert _pack2_pair(data, a, ck.landed, info, **kw) is not None
        assert _pack2_pair(data, a, ck.landed, info, force_w=ck.W,
                           force_class_np=cnp, force_patch_np=pnp,
                           force_wide=wide, **kw) is not None


def test_scan_library_builds_from_two_processes_at_once(tmp_path):
    """Two processes that build the scan library into one empty
    directory at the same time both load a working library: one
    compiles while the other waits on the lock, and neither sees a
    half-written file. The stamp names the flags and the CPU."""
    code = ("import ctypes, sys\n"
            "import numpy as np\n"
            "from zflac_tpu_torch.index import native_indexer as ni\n"
            "from zflac_tpu_torch.encoder import encode, EncoderConfig\n"
            "from zflac_tpu_torch.testing import tone_mix\n"
            "ni._lib = ni.bind(ctypes.CDLL(ni.build(sys.argv[1])))\n"
            "pcm = tone_mix(3000, 2, 16, seed=1)\n"
            "out, _ = ni.decode_cpu_native(encode(pcm, 44100, 16,\n"
            "                              EncoderConfig(block_size=512)))\n"
            "assert np.array_equal(out, pcm.astype(np.int16).reshape(-1))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=_REPO, env=env, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    assert sorted(os.listdir(tmp_path)) == [
        ".lock", ni.LIB_NAME, ni.LIB_NAME + ".stamp"]
    stamp = (tmp_path / (ni.LIB_NAME + ".stamp")).read_text()
    assert " ".join(ni.CXX_FLAGS) in stamp and "cpu " in stamp
