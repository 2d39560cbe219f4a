"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports JAX or anything of the JAX package `repro`; and the
package imports with JAX made unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_and_no_repro(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core.scaleout, repro_torch.kernels, "
        "repro_torch.convert, repro_torch.models.zoo, repro_torch.serving.engine, "
        "repro_torch.launch.serve, repro_torch.kernels.flash_attention, "
        "repro_torch.phy.process, repro_torch.core.classifier, repro_torch.serving, "
        "repro_torch.serving.hdc, repro_torch.serving.scheduler, repro_torch.serving.slotring, "
        "repro_torch.train.loop, repro_torch.launch.train, repro_torch.checkpoint, "
        "repro_torch.data\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
