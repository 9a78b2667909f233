"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

The sources under ``csrc/`` are compiled at first use into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library lands in ``<repo>/build/torch_kernels/`` under a name
that carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  Without ``nvcc`` the build raises: a CUDA
tensor never silently falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuad_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Tuple[Path, str]:
    """Compile the kernels unless the hashed library exists.  Returns the
    library path and the compiler's output (``-Xptxas -v`` register and
    shared-memory report; empty when the library was already built)."""
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every exported
    function's ``argtypes``/``restype`` declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.uad_median5_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uad_median5_f32.restype = ctypes.c_int
    return lib
