"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``helpers/csrc/`` exposes a plain ``extern "C"``
launcher.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``helpers/_build/`` (listed in ``.gitignore``) and
loaded with ``ctypes``; no PyTorch headers are involved, so a build takes
seconds.  The library's file name carries a hash of the source, so an
edited source rebuilds and an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module on
a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Path, "Built"] = {}


class Counts:
    """Plain integer counts of one kernel: launches, and calls of its
    plain version (CPU tensors).  Each wrapper bumps them where it launches
    or takes the plain path, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_s: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are compiled from source at first use")


def load_library(source: Path) -> Built:
    """Compile ``source`` (once per content hash) and load it."""
    source = Path(source).resolve()
    with _lock:
        hit = _loaded.get(source)
        if hit is not None:
            return hit
        digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
        out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
        build_s, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {source.name}:\n{log}")
            os.replace(tmp, out)    # atomic: concurrent builders agree
        built = Built(ctypes.CDLL(str(out)), out, build_s, log)
        _loaded[source] = built
        return built
