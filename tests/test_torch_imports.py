"""The port stands alone: no module of `repro_torch` and no part of
`chip_smoke.py` imports JAX or the reference package `repro`, at import
time or inside a function."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

_FRESH = r"""
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
try:
    runpy.run_path(sys.argv[1], run_name="chip_smoke_import_check")
except SystemExit:
    pass  # no card here: the script stops after its imports
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def _imported(path: Path) -> list[str]:
    """Every module an `import` / `from ... import` in `path` names, at any
    depth of the file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_jax_or_reference_import_statement():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_fresh_interpreter_loads_no_jax_or_reference_module():
    """Importing every module of the port, then running chip_smoke.py up to
    its device check, in a fresh interpreter leaves no `jax*` or `repro.*`
    module in `sys.modules`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _FRESH, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) > 25 and bad == "[]", proc.stdout
