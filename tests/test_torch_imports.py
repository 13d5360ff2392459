"""The port never imports ``jax`` or anything of ``deeplearning4j_tpu``
(whose ``__init__`` imports jax): checked on the sources, and by
importing every port module in a fresh interpreter where ``jax`` is
poisoned."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name)
           for f in files for name in _imported(ast.parse(f.read_text()))
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_every_module_loads_no_jax(tmp_path):
    poison = tmp_path / "poison"
    poison.mkdir()
    for name in ("jax", "jaxlib"):
        (poison / f"{name}.py").write_text(
            "raise ImportError('the port must not import jax')\n")
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{REPO}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) > 20
