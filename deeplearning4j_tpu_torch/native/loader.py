"""Builds and loads the port's native C++ runtime core
(``native/src/dl4j_tpu_native.cpp``, the port's own copy of the source).

At first use the source is compiled with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` (``$CXX`` overrides the compiler) into ``native/_build/``
(listed in ``.gitignore``) and loaded with ``ctypes``, through the same
build-and-cache policy as the CUDA kernels (``helpers/cuda_build.
load_library``): the library's file name carries a hash of the source,
the compiler and the flags, and a build is written under a name of its
own and ``os.replace``-d into place, so processes building at once (test
workers, fleet replicas) agree on one file.

Unlike the reference loader, nothing degrades: a build or load that fails
raises with the compiler's output, and no caller switches to a plain
version because of it.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

from deeplearning4j_tpu_torch.helpers import cuda_build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "src" / "dl4j_tpu_native.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def build_digest() -> str:
    """Hash of what a build depends on: the source, the compiler and the
    flags."""
    return cuda_build.build_digest(SOURCE, (compiler(), *CXX_FLAGS))


def _bind(lib: ctypes.CDLL) -> None:
    c_long = ctypes.c_long
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_i64p = ctypes.POINTER(ctypes.c_int64)

    lib.dl4j_native_abi_version.restype = ctypes.c_int

    lib.csv_dims.argtypes = [ctypes.c_char_p, c_long, ctypes.c_char, c_long,
                             ctypes.POINTER(c_long)]
    lib.csv_dims.restype = c_long
    lib.csv_parse.argtypes = [ctypes.c_char_p, c_long, ctypes.c_char, c_long,
                              c_fp, c_long, c_long, ctypes.c_int]
    lib.csv_parse.restype = c_long

    lib.idx_images.argtypes = [ctypes.c_char_p, c_long, c_fp, c_long,
                               ctypes.c_int]
    lib.idx_images.restype = c_long
    lib.idx_labels.argtypes = [ctypes.c_char_p, c_long, c_fp, c_long, c_long]
    lib.idx_labels.restype = c_long

    lib.gather_rows_f32.argtypes = [c_fp, c_long, c_i64p, c_long, c_fp,
                                    ctypes.c_int]
    lib.gather_rows_f32.restype = None

    lib.batcher_create.argtypes = [c_fp, c_fp, c_long, c_long, c_long, c_long,
                                   ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.batcher_create.restype = ctypes.c_void_p
    lib.batcher_next.argtypes = [ctypes.c_void_p, c_fp, c_fp,
                                 ctypes.POINTER(c_long)]
    lib.batcher_next.restype = ctypes.c_int
    lib.batcher_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.batcher_reset.restype = None
    lib.batcher_destroy.argtypes = [ctypes.c_void_p]
    lib.batcher_destroy.restype = None

    lib.dataset_write.argtypes = [ctypes.c_char_p, c_fp, c_fp, c_long, c_long,
                                  c_long]
    lib.dataset_write.restype = c_long
    lib.dataset_read_header.argtypes = [ctypes.c_char_p, c_i64p, c_i64p,
                                        c_i64p]
    lib.dataset_read_header.restype = c_long
    lib.dataset_read.argtypes = [ctypes.c_char_p, c_fp, c_fp]
    lib.dataset_read.restype = c_long

    version = lib.dl4j_native_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"native build: {lib._name} has ABI {version}, "
                           f"expected {ABI_VERSION}")


def build() -> cuda_build.Built:
    """Compile the source once per build digest into ``BUILD_DIR``, load
    and bind it; raises ``RuntimeError`` with the compiler's output when
    the compiler is missing or fails, or when the library does not load
    or has another ABI."""
    try:
        return cuda_build.load_library(SOURCE, command=(compiler(),),
                                       flags=CXX_FLAGS, build_dir=BUILD_DIR,
                                       on_load=_bind)
    except (RuntimeError, AttributeError) as e:
        raise RuntimeError(f"native build: {e}") from e


def lib() -> ctypes.CDLL:
    """The loaded native library, built on first use (raises on
    failure)."""
    return build().lib
