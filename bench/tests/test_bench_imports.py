"""Neither a run nor a file of the benchmark loads JAX, Flax or the JAX
package (`repro`); module names are compared by their whole top-level name,
so the port, `repro_torch`, passes."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench_tiny import ROOT, harness

PROBE = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import bench_tiny
from bench import harness
result, _ = bench_tiny.run("hdc-paper-closed", trace=True)
assert result["correct"], result
print(sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")[:1])
print(harness.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        tests=str(ROOT / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert loaded == "['repro_torch']" and forbidden == "[]"


def test_no_bench_file_imports_jax():
    for path in (ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                                      "flaxen", "bench.reference"]) == []
    assert harness.forbidden_modules(["repro.core.scaleout", "jax._src", "jaxlib",
                                      "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]
