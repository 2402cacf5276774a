"""Profiling primitives of the port: build accounting and executable capture.

The counterpart of `repro.obs.xprof`, with the same names and meaning where
the port has the same thing:

* **compile accounting** — a compile in the port is an ``nvcc`` build of a
  kernel library (`repro_torch.kernels.build.build_many`). After each
  library it builds, ``build_many`` calls :func:`on_build`, which fans
  ``(seconds, aot)`` out to the sinks of :func:`add_sink` /
  :func:`count_compiles` (``aot`` is False unless the build ran inside
  :func:`aot_scope`; nothing in the port builds there). Each build is also
  held, by library name, until a profiled dispatch of a site that runs that
  library takes it (:func:`take_builds`): one library serves every shape
  of its kernel, and chip runs build all of them up front, before any trace
  is open, so the first profiled dispatch of the library is where its build
  is accounted. Plain-PyTorch sites (the population finetune) compile
  nothing.

* **artifact capture** — :func:`capture_executable` returns the reference's
  capture keys, each only where the port can have it: ``signature`` (a hash
  of the site and the arguments' shapes and dtypes); ``flops`` and
  ``bytes_accessed`` as the caller passes them (a kernel site passes its
  kernel's analytic operation and byte counts; a plain-PyTorch site the
  matmul-class FLOPs that `torch.utils.flop_counter.FlopCounterMode` read
  over its first dispatch); ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` from the tensors' sizes; and
  ``generated_code_size_in_bytes`` as the size of the kernel's ``.so``.
  ``temp_size_in_bytes`` is left out: it would need
  ``torch.cuda.reset_peak_memory_stats()``, which would clobber the peaks
  that callers read through ``torch.cuda.max_memory_allocated``. The
  reference's capture degrades the same way where its backend reports
  nothing.

Nothing here touches the computation being profiled, so profiling cannot
perturb results.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

EVENT_COMPILE = "/repro_torch/kernels/build/nvcc_duration"

_lock = threading.Lock()
_sinks: List[Callable[[float, bool], None]] = []
_aot = threading.local()            # .depth > 0 => profiler-initiated
# library name -> nvcc seconds of builds no profiled dispatch has taken yet
_pending: Dict[str, List[float]] = {}


def _in_aot_scope() -> bool:
    return getattr(_aot, "depth", 0) > 0


def on_build(name: str, seconds: float) -> None:
    """Called by `kernels.build.build_many` after it built ``lib<name>``."""
    with _lock:
        _pending.setdefault(name, []).append(float(seconds))
        sinks = list(_sinks)
    aot = _in_aot_scope()
    for sink in sinks:
        sink(float(seconds), aot)


def take_builds(name: str) -> List[float]:
    """The seconds of every build of ``lib<name>`` not taken before; a
    profiled dispatch of a site running that library records them as its
    compiles."""
    with _lock:
        return _pending.pop(name, [])


def add_sink(sink: Callable[[float, bool], None]) -> None:
    """Attach ``sink(seconds, aot)``, called after every kernel build."""
    with _lock:
        if sink not in _sinks:
            _sinks.append(sink)


def remove_sink(sink: Callable[[float, bool], None]) -> None:
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)


class aot_scope:
    """``with aot_scope():`` — builds inside are profiler-initiated and
    reach sinks with ``aot=True``."""

    def __enter__(self):
        _aot.depth = getattr(_aot, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _aot.depth -= 1
        return False


class CompileCount:
    """A sink accumulating build counts and seconds, split into
    dispatch-triggered vs profiler-initiated (AOT)."""
    __slots__ = ("compiles", "compile_s", "aot_compiles", "aot_compile_s")

    def __init__(self):
        self.compiles = 0
        self.compile_s = 0.0
        self.aot_compiles = 0
        self.aot_compile_s = 0.0

    def __call__(self, seconds: float, aot: bool) -> None:
        if aot:
            self.aot_compiles += 1
            self.aot_compile_s += seconds
        else:
            self.compiles += 1
            self.compile_s += seconds


class count_compiles:
    """``with count_compiles() as c:`` — count every kernel build in the
    body (works with tracing off; a warm phase builds nothing)."""

    def __enter__(self) -> CompileCount:
        self._count = CompileCount()
        add_sink(self._count)
        return self._count

    def __exit__(self, *exc):
        remove_sink(self._count)
        return False


# ---------------------------------------------------------------------------
# artifact capture
# ---------------------------------------------------------------------------


def _arrays(obj) -> Iterator[Any]:
    """The tensors and numpy arrays of a nested dict/list/tuple, dict keys
    in sorted order."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _arrays(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _arrays(v)


def _nbytes(obj) -> int:
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
               else a.nbytes for a in _arrays(obj))


def signature_hash(site: str, args: Sequence = ()) -> str:
    """Stable short hash of the site and its arguments' shapes and dtypes,
    for cross-run executable identity."""
    sig = repr((site, [(tuple(a.shape), str(a.dtype))
                       for a in _arrays(args)]))
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


def capture_executable(site: str, args: Sequence = (), *,
                       outputs: Any = None,
                       flops: Optional[float] = None,
                       bytes_accessed: Optional[float] = None,
                       library: Optional[str] = None) -> Dict[str, Any]:
    """-> {"signature": ..., "flops": ..., "bytes_accessed": ...,
    <memory fields>} with only the fields the port has; ``{"error":
    <ExcName>}`` added if reading one failed."""
    out: Dict[str, Any] = {}
    try:
        out["signature"] = signature_hash(site, args)
        if flops is not None:
            out["flops"] = float(flops)
        if bytes_accessed is not None:
            out["bytes_accessed"] = float(bytes_accessed)
        if library is not None:
            from repro_torch.kernels import build
            so = build.library_path(library)
            if so.exists():
                out["generated_code_size_in_bytes"] = so.stat().st_size
        out["argument_size_in_bytes"] = _nbytes(args)
        if outputs is not None:
            out["output_size_in_bytes"] = _nbytes(outputs)
    except Exception as e:                          # noqa: BLE001
        # profiling must never take down the computation it observes
        out.setdefault("error", type(e).__name__)
    return out


def backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


__all__ = ["EVENT_COMPILE", "CompileCount", "add_sink", "aot_scope",
           "backend", "capture_executable", "count_compiles", "on_build",
           "remove_sink", "signature_hash", "take_builds"]
