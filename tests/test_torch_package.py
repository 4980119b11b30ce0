"""The port stands alone: nothing under agrl_torch/ (nor chip_smoke.py)
imports JAX, Flax or agrl_tpu, and importing every port module leaves
JAX unloaded."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "agrl_tpu")


def _port_sources():
    """The package's Python files; `_build/` holds generated output only."""
    pkg = ROOT / "agrl_torch"
    return sorted(p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts)


def _port_files():
    return _port_sources() + [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 20
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files
        for mod in _imported(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_sources()
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
