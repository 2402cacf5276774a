"""Build and load the hand-written CUDA kernels of `repro_torch.csrc`.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``src/repro_torch/_build/`` (listed in ``.gitignore``), then loaded with
``ctypes``. The library's name carries a hash of the source, of every shared
header ``csrc/*.cuh`` and of the flags, so an edited kernel or header is
rebuilt and a stale library is never loaded. No ``nvcc`` on a machine that
asks for a kernel is an error. Every build is reported to
`repro_torch.obs.xprof.on_build`, the port's compile event.
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
from typing import Dict, Iterable, List

from repro_torch.obs import xprof

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel of the package, one ``csrc/<name>.cu`` each
KERNELS = ("netlist_sim", "quant_matmul", "flash_attention", "ssm_scan",
           "clustered_matmul", "block_sparse_matmul", "flash_attention_bwd",
           "ssm_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": wall time from the start of its build batch until its
# nvcc finished, "log": nvcc/ptxas output}; filled by the builds this
# process ran (empty when the library was already on disk)
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
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # every header, included or not: a header edit rebuilds all kernels
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_many(names: Iterable[str]) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` process per source, all started together."""
    out = {n: library_path(n) for n in names}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            cmd: List[str] = [compiler, *NVCC_FLAGS, "-o", tmp,
                              str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out[n])   # atomic: concurrent builds agree
            BUILD_INFO[n] = {"seconds": time.perf_counter() - t0,
                             "log": log}
            # a build is the port's compile: count_compiles sinks see it,
            # and the first profiled dispatch of the library records it
            xprof.on_build(n, BUILD_INFO[n]["seconds"])
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_many([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>``; cached per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
