"""Build and load the hand-written CUDA kernels of `repro_torch.csrc`.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``src/repro_torch/_build/`` (listed in ``.gitignore``), then loaded with
``ctypes``. The library's name carries a hash of the source and flags, so an
edited kernel is rebuilt and a stale one is never loaded. No ``nvcc`` on a
machine that asks for a kernel is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": build time, "log": nvcc/ptxas output}; filled by the
# build this process ran (empty when the library was already on disk)
BUILD_INFO: Dict[str, Dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd: List[str] = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": res.stdout + res.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>``; cached per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
