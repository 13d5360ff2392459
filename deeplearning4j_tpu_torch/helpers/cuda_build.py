"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``helpers/csrc/`` exposes a plain ``extern "C"``
launcher.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``helpers/_build/`` (listed in ``.gitignore``) and
loaded with ``ctypes``; no PyTorch headers are involved, so a build takes
seconds.  The library's file name carries a hash of the source, of every
header beside it (``csrc/*.cuh``) and of the compile flags, so an edited
source or header, or a changed flag, rebuilds, and an unchanged build is
loaded as it is.  ``load_library`` takes another compiler and build
directory too: the native C++ core (``native/loader.py``) builds through it
with g++.

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
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Tuple, "Built"] = {}


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
    log: str            # the compiler's output (nvcc: ptxas's register report)


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


def build_digest(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of what a build of ``source`` depends on: the source, the
    port's headers beside it and the flags (a compiler other than nvcc
    among them)."""
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:12]


def load_library(source: Path, *, command: Optional[Sequence[str]] = None,
                 flags: Sequence[str] = NVCC_FLAGS,
                 build_dir: Optional[Path] = None,
                 on_load: Optional[Callable[[ctypes.CDLL], None]] = None
                 ) -> Built:
    """Compile ``source`` (once per build digest) and load it.

    ``command`` is the compiler (nvcc when ``None``); another compiler is
    hashed into the digest beside ``flags``.  The library goes to
    ``build_dir`` (``BUILD_DIR`` when ``None``) under a name of its own
    and is ``os.replace``-d into place, so processes that build at once
    agree on one file.  ``on_load`` binds and checks a freshly loaded
    library before it is cached.  A compiler that cannot run or fails, or
    a library that does not load, raises ``RuntimeError`` with the
    compiler's output."""
    source = Path(source).resolve()
    build_dir = Path(build_dir if build_dir is not None else BUILD_DIR)
    key = (source, tuple(command or ()), tuple(flags), build_dir)
    with _lock:
        hit = _loaded.get(key)
        if hit is not None:
            return hit
        cc = list(command) if command else [_nvcc()]
        digest = build_digest(source, (*command, *flags) if command
                              else tuple(flags))
        out = build_dir / f"lib{source.stem}-{digest}.so"
        build_s, log = 0.0, ""
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [*cc, *flags, "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(
                    f"could not run {' '.join(cmd)}: {e}") from e
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cc[0]} failed ({proc.returncode}) on "
                                   f"{source.name}:\n{log}")
            os.replace(tmp, out)    # atomic: concurrent builders agree
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        if on_load is not None:
            on_load(lib)
        built = Built(lib, out, build_s, log)
        _loaded[key] = built
        return built
