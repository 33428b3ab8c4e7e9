"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, loaded with ctypes, through the hash-keyed build cache in
stenos_tpu_torch/build/ (see _build.py). ptxas's register/shared-memory
report is kept beside each library as <name>.ptxas.txt. Nothing here runs at
import: the first kernel launch builds, or `build(...)` builds several
sources in parallel.
"""

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

from .._build import BUILD_DIR, cached_lib

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib(name: str) -> str:
    return cached_lib([_nvcc(), *FLAGS], os.path.join(CSRC, f"{name}.cu"),
                      name, os.path.join(BUILD_DIR, f"{name}.ptxas.txt"))


def build(names) -> None:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together. Raises with the compiler's output."""
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        for f in [ex.submit(_lib, name) for name in names]:
            f.result()


def load(name: str, signatures: dict):
    """ctypes handle of the named kernel library, built on first use.
    signatures: C function name -> argtypes (every function returns int)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(_lib(name))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
