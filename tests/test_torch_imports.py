"""The port never imports ``jax`` or anything of ``deeplearning4j_tpu``
(whose ``__init__`` imports jax): checked on the sources, and by
importing every port module in a fresh interpreter where ``jax`` is
poisoned.  ``chip_smoke.py``, which runs on a machine without JAX, is
held to the same rule."""

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


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    names = list(_imported(ast.parse((REPO / "chip_smoke.py").read_text())))
    assert any(n.startswith("deeplearning4j_tpu_torch") for n in names)
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []


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


def test_every_module_of_the_online_and_observability_slice_is_walked():
    """The modules of the online-learning slice are among those the
    poisoned-jax import above loads (a package without ``__init__``
    would be skipped by ``walk_packages``)."""
    import pkgutil

    import deeplearning4j_tpu_torch as pkg

    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    new = ["datasets.iterator", "evaluation", "evaluation.evaluation",
           "evaluation.regression", "observability.fitmetrics",
           "observability.introspection", "observability.numerics",
           "observability.kerneldiff", "optimize.listeners", "ui",
           "ui.stats", "ui.storage", "online", "online.consumer",
           "online.promotion", "online.pipeline"]
    assert sorted(f"deeplearning4j_tpu_torch.{n}" for n in new
                  if f"deeplearning4j_tpu_torch.{n}" not in walked) == []


def test_every_module_of_the_fleet_and_profiling_slice_is_walked():
    """The fleet's, the profiler's and the regression sentinel's modules
    are among those the poisoned-jax import above loads."""
    import pkgutil

    import deeplearning4j_tpu_torch as pkg

    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    new = ["fleet", "fleet.placement", "fleet.router", "fleet.replica",
           "fleet.supervisor", "fleet.replica_main", "fleet.frontend",
           "fleet.rollout", "observability.profiling",
           "observability.regression", "observability.fleet",
           "helpers.cost"]
    assert sorted(f"deeplearning4j_tpu_torch.{n}" for n in new
                  if f"deeplearning4j_tpu_torch.{n}" not in walked) == []


def test_every_module_of_the_pretraining_slice_is_walked():
    """The pretraining slice's modules (the AutoEncoder and RBM layers,
    the MoE layer, the full-batch solvers, early stopping) are among
    those the poisoned-jax import above loads."""
    import pkgutil

    import deeplearning4j_tpu_torch as pkg

    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    new = ["nn.layers.autoencoder", "nn.layers.moe", "optimize.solvers",
           "earlystopping"]
    assert sorted(f"deeplearning4j_tpu_torch.{n}" for n in new
                  if f"deeplearning4j_tpu_torch.{n}" not in walked) == []


def test_every_module_of_the_data_and_dashboard_slice_is_walked():
    """The data path's and the dashboard's modules (the native loader,
    the dataset readers, the multi-dataset and record iterators, export,
    the UI server, components and renders) are among those the
    poisoned-jax import above loads, and the native source they build is
    the port's own."""
    import pkgutil

    import deeplearning4j_tpu_torch as pkg

    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    new = ["native", "native.loader", "datasets.multidataset",
           "datasets.datavec", "datasets.export", "datasets.mnist",
           "datasets.cifar", "datasets.lfw", "datasets.curves",
           "datasets.iris", "ui.components", "ui.render", "ui.server"]
    assert sorted(f"deeplearning4j_tpu_torch.{n}" for n in new
                  if f"deeplearning4j_tpu_torch.{n}" not in walked) == []
    assert (PORT / "native" / "src" / "dl4j_tpu_native.cpp").is_file()
    loader = (PORT / "native" / "loader.py").read_text()
    assert "deeplearning4j_tpu/" not in loader


def test_replica_main_help_imports_no_jax(tmp_path):
    """``python -m deeplearning4j_tpu_torch.fleet.replica_main --help``
    (what the supervisor spawns) runs with ``jax`` poisoned."""
    poison = tmp_path / "poison"
    poison.mkdir()
    for name in ("jax", "jaxlib"):
        (poison / f"{name}.py").write_text(
            "raise ImportError('the port must not import jax')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{REPO}"
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.fleet.replica_main",
         "--help"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--device" in proc.stdout and "--compute-dtype" in proc.stdout
