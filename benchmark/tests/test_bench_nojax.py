"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (`zflac_tpu_torch` begins with
`zflac_tpu` and is neither)."""

import ast
import os
import subprocess
import sys

import run as run_mod
from harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "zflac_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(manifest.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_whole_name_check():
    saved = dict(sys.modules)
    try:
        for name in list(sys.modules):
            if name.split(".")[0] in FORBIDDEN:
                del sys.modules[name]
        sys.modules["zflac_tpu_torch_fake"] = sys
        assert run_mod.forbidden_modules() == []
        sys.modules["zflac_tpu.runtime"] = sys
        assert run_mod.forbidden_modules() == ["zflac_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['benchmark', '.'];\n"
        "import torch; torch.set_num_threads(1)\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from bench_cases import traffic\n"
        "from harness import cell\n"
        "import run\n"
        "for wl in ('cd16.track.device', 'speech.utt.host'):\n"
        "    res, _ = cell.run_cell(wl, 3, 0.2, False, device='cpu',"
        " traffic=traffic(wl))\n"
        "    assert res['correct']\n"
        "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
