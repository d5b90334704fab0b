"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Kernel ``name`` is ``csrc/<name>.cu``, a file with a plain C interface.  It
is compiled on first use with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
The library name carries a hash of the source, so an edited kernel is
rebuilt and a stale one never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name → nvcc output of its build in this process (``-Xptxas -v``:
# registers, shared memory, spills)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a CUDA host")
    return found


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOGS[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: never a half-written library
    lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib
