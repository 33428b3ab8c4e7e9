"""Build cache shared by the CUDA kernels (ops/_cuda.py) and the native host
runtime (native/__init__.py).

A source is compiled into a shared library in stenos_tpu_torch/build/, named
by a hash of the source and the compiler flags: an edited source or flag
rebuilds, an unchanged one is reused. Delete the directory to force a
rebuild.
"""

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")


def cached_lib(cmd, src: str, stem: str, log_path: str = None) -> str:
    """Path of src compiled by cmd (compiler, then flags) as a shared
    library, building it first when it is not cached. The compiler's output
    goes to log_path when it builds. Raises with that output on failure."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd[1:]).encode())
    path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-PID temp: concurrent builders (test workers) must not scribble
    # each other's half-written .so before the atomic os.replace
    tmp = f"{path}.tmp.{os.getpid()}.so"
    r = subprocess.run([*cmd, src, "-o", tmp], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    if log_path:
        with open(log_path, "w") as f:
            f.write(r.stdout)
    if r.returncode:
        raise RuntimeError(f"building {src} failed:\n{r.stdout}")
    os.replace(tmp, path)
    return path
