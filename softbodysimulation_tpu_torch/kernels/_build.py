"""Build the port's CUDA sources with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built on first use, never at import (the package must import
where there is no CUDA toolkit), into ``softbodysimulation_tpu_torch/_build/``
under a name that hashes the sources, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source builds anew and an unchanged one loads
the existing file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str, sources: Sequence[str],
                 extra_flags: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    headers = sorted(p.name for p in CSRC_DIR.glob("*.cuh"))
    for src in (*sources, *headers):
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[str],
                  extra_flags: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile ``csrc/<sources>`` (with ``NVCC_FLAGS`` and the library's own
    ``extra_flags``) into the hashed library unless it exists.  Returns
    (path, the compiler's output; empty when nothing was built)."""
    path = library_path(name, sources, extra_flags)
    if path.exists():
        return path, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return path, proc.stdout + proc.stderr


def load_library(name: str, sources: Sequence[str],
                 extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    path, _ = build_library(name, sources, extra_flags)
    return ctypes.CDLL(str(path))
