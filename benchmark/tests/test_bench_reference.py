"""The reference is plain torch and numpy: it imports nothing of the
program and nothing of JAX."""

import ast
import os
import subprocess
import sys

from harness import manifest

PLAIN = {"__future__", "numpy", "torch"}


def test_reference_imports_only_plain_modules():
    for f in ("reference.py", "control.py"):
        path = os.path.join(manifest.BENCH_DIR, "harness", f)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= PLAIN
            elif isinstance(node, ast.ImportFrom) and node.level:
                # Only the reference itself, from beside it.
                assert node.module is None and \
                    [a.name for a in node.names] == ["reference"]
            elif isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] in PLAIN


def test_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, 'benchmark')\n"
            "import harness.reference, harness.control\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'zflac_tpu_torch', 'zflac_tpu', 'jax', 'jaxlib'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
