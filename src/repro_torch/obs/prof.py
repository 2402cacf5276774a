"""Executable observatory: a process-wide registry of the port's dispatch
sites, the counterpart of `repro.obs.prof`.

Every instrumented boundary (the six kernel wrappers, K1's two bodies as
two sites, and the population QAT finetune) dispatches through
:func:`dispatch(site, key, ...) <dispatch>`, where ``key`` is the call's
static-shape tuple — what the reference's jit compiles one executable per.
A kernel wrapper enters it through :func:`kernel`, the one hook a launch
reports to, which also hands the launch's analytic FLOPs and bytes to
whatever :func:`watch` es the launches (`roofline.analysis.StepCounter`).
The registry records, per key, with the reference's schema and names so
`repro_torch.obs.report` (and the reference's) read it:

* the trigger **site** and a **signature hash** of the arguments' shapes
  and dtypes;
* the first dispatch's **capture** (`repro_torch.obs.xprof`): a kernel
  site's analytic FLOPs and bytes, passed in by its wrapper from its
  shapes (``FlopCounterMode`` cannot see a ``ctypes`` launch and would
  read 0); a plain-PyTorch site's FLOPs counted by ``FlopCounterMode``
  over that first dispatch; argument, output and ``.so`` sizes;
* **compiles**: the ``nvcc`` builds of the site's kernel library that no
  earlier profiled dispatch took (`xprof.take_builds`). A *recompile* — a
  build landing on a key already dispatched — would need the library
  rebuilt inside one process, which never happens (tested);
* a per-key **dispatch count**, and ``device_ms``, the body's time on the
  card between two CUDA events.

A dispatch on CUDA synchronizes its device at the end (the counterpart of
``block_until_ready``), so its span and ``device_ms`` cover real execution.
Everything rides the ambient ``REPRO_TRACE`` switch exactly like
`repro_torch.obs.trace`: with tracing off, :func:`dispatch` is never called
(instrumented wrappers keep their early-return fast path), the registry is
never touched and nothing synchronizes. With tracing on, each dispatch also
emits ``prof.compile`` / ``prof.executable`` trace events so the report can
rebuild the registry from the JSONL.

The search runtime snapshots the registry into every checkpoint and
``resume()`` restores it dict-equal. Compile counts live here, not in the
metrics counters: a resumed process rebuilds nothing it has on disk but
may build what it lacks, so they cannot keep the counters' bit-identity.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.obs import trace as TR
from repro_torch.obs import xprof

_LOCK = threading.Lock()


class ExecutableRegistry:
    """Keyed store of executable records + process compile totals.

    Records are plain JSON-able dicts::

        {"site": str, "signature": str?, "dispatches": int,
         "compiles": int, "compile_s": float,
         "aot_compiles": int, "aot_compile_s": float, "device_ms": float?,
         "flops": float?, "bytes_accessed": float?, <memory fields>?}
    """

    def __init__(self):
        self.executables: Dict[str, Dict[str, Any]] = {}
        self.compiles = 0
        self.compile_s = 0.0
        self.aot_compiles = 0
        self.aot_compile_s = 0.0

    # -- record surface ------------------------------------------------------

    def record(self, site: str, key: str) -> Dict[str, Any]:
        """Get-or-create the record for ``key`` (thread-safe)."""
        rec = self.executables.get(key)
        if rec is None:
            with _LOCK:
                rec = self.executables.setdefault(key, {
                    "site": site, "dispatches": 0,
                    "compiles": 0, "compile_s": 0.0,
                    "aot_compiles": 0, "aot_compile_s": 0.0})
        return rec

    def on_compile(self, rec: Optional[Dict[str, Any]], seconds: float,
                   aot: bool) -> None:
        with _LOCK:
            if aot:
                self.aot_compiles += 1
                self.aot_compile_s += seconds
            else:
                self.compiles += 1
                self.compile_s += seconds
            if rec is not None:
                k = "aot_compiles" if aot else "compiles"
                rec[k] += 1
                rec[k[:-1] + "_s"] = rec.get(k[:-1] + "_s", 0.0) + seconds

    def reset(self) -> None:
        with _LOCK:
            self.executables.clear()
            self.compiles = 0
            self.compile_s = 0.0
            self.aot_compiles = 0
            self.aot_compile_s = 0.0

    # -- checkpoint surface --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able, keys sorted — byte-stable for equal states (the same
        convention as `metrics.MetricsRegistry.snapshot`)."""
        with _LOCK:
            return {
                "executables": {k: {f: x for f, x in sorted(v.items())
                                    if not f.startswith("_")}
                                for k, v in sorted(self.executables.items())},
                "totals": {"aot_compile_s": self.aot_compile_s,
                           "aot_compiles": self.aot_compiles,
                           "compile_s": self.compile_s,
                           "compiles": self.compiles},
            }

    def restore(self, snap: Optional[Dict[str, Any]]) -> None:
        """Replace state with a snapshot's — exact, so a restored registry
        is dict-equal to the one at save time. Tolerates missing sections
        (checkpoints without a profile restore to empty)."""
        self.reset()
        if not snap:
            return
        with _LOCK:
            for k, v in snap.get("executables", {}).items():
                self.executables[k] = dict(v)
            t = snap.get("totals", {})
            self.compiles = int(t.get("compiles", 0))
            self.compile_s = float(t.get("compile_s", 0.0))
            self.aot_compiles = int(t.get("aot_compiles", 0))
            self.aot_compile_s = float(t.get("aot_compile_s", 0.0))


# the process-wide registry (one set of kernel libraries per process)
REGISTRY = ExecutableRegistry()


def profiling() -> bool:
    """Profiling is on iff tracing is on (one ambient switch)."""
    return TR.active()


def key_str(key: Any) -> str:
    return key if isinstance(key, str) else repr(key)


# -- the kernel-launch hook ----------------------------------------------------

# fn(name, flops, bytes, library) for each launch of a hand-written kernel
_WATCHERS: List[Callable[[str, int, int, str], None]] = []


def watch(fn: Callable[[str, int, int, str], None]) -> None:
    """Call ``fn(name, flops, bytes, library)`` for every launch a kernel
    wrapper reports (:func:`kernel`, :func:`launched`), ``name`` its site
    without ``kernels.``. A `roofline.analysis.StepCounter` watches while
    it counts."""
    with _LOCK:
        _WATCHERS.append(fn)


def unwatch(fn: Callable[[str, int, int, str], None]) -> None:
    with _LOCK:
        _WATCHERS.remove(fn)


def watching() -> bool:
    """Whether anything watches the launches: the only case in which a
    kernel wrapper takes its meta branch (`kernels.check_device`)."""
    return bool(_WATCHERS)


def observed() -> bool:
    """Whether a launch reports at all (a watcher, or the profiler): when
    not, a wrapper launches without pricing its launch."""
    return bool(_WATCHERS) or profiling()


def launched(site: str, flops: int, bytes_accessed: int,
             library: str) -> None:
    """Tell every watcher of one launch of the kernel at ``site``, priced
    by its wrapper's analytic cost. A wrapper's meta branch calls this
    alone and launches nothing."""
    name = site[len("kernels."):] if site.startswith("kernels.") else site
    for fn in list(_WATCHERS):
        fn(name, int(flops), int(bytes_accessed), library)


class _NoSpan:
    @staticmethod
    def set(**attrs) -> None:
        pass


@contextlib.contextmanager
def kernel(site: str, key: Any, *, device, flops: int, bytes_accessed: int,
           library: str, args: Any = (), **attrs):
    """One launch of a hand-written kernel on the card, the hook its
    wrapper enters around the launch when :func:`observed`: the watchers
    learn of it (:func:`launched`) and, with profiling on, the launch is a
    :func:`dispatch` of ``site`` specialized on ``key``. Yields what
    :func:`dispatch` yields (a stand-in that records nothing when not
    profiling)."""
    launched(site, flops, bytes_accessed, library)
    if not profiling():
        yield _Call(_NoSpan)
        return
    with dispatch(site, key, device=device, args=args, flops=flops,
                  bytes_accessed=bytes_accessed, library=library,
                  **attrs) as call:
        yield call


class _Call:
    """What :func:`dispatch` yields: ``set(**attrs)`` adds attributes to
    the dispatch's span; ``outputs`` takes the call's result, for the
    capture's output size."""
    __slots__ = ("span", "outputs")

    def __init__(self, span):
        self.span, self.outputs = span, None

    def set(self, **attrs) -> "_Call":
        self.span.set(**attrs)
        return self


@contextlib.contextmanager
def dispatch(site: str, key: Any, *, device=None, args: Any = (),
             flops: Optional[float] = None,
             bytes_accessed: Optional[float] = None,
             library: Optional[str] = None, count_flops: bool = False,
             **attrs):
    """Wrap one dispatch of the site specialized on ``key``.

    Must be called only when :func:`profiling`. ``device``: the call's
    device; on CUDA the body is timed by CUDA events and the device
    synchronized at the end. ``args``: the call's tensors, for the
    signature and argument size; the body sets ``call.outputs`` for the
    output size. ``flops`` / ``bytes_accessed``: a kernel site's analytic
    counts; ``count_flops=True`` (plain-PyTorch sites only) counts FLOPs
    with ``FlopCounterMode`` over the first dispatch instead.
    ``library``: the kernel library the site runs, whose pending builds
    this dispatch records as compiles.
    """
    kstr = key_str(key)
    first = TR.first_call(key)
    rec = REGISTRY.record(site, kstr)
    capture = "signature" not in rec
    cuda = device is not None and torch.device(device).type == "cuda"
    counter = contextlib.nullcontext()
    if capture and count_flops and flops is None:
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
    call = None
    try:
        with TR.span(site, key=kstr, first=first, **attrs) as sp:
            call = _Call(sp)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            with counter:
                yield call
            if cuda:
                stop.record()
                torch.cuda.synchronize(device)
                ms = start.elapsed_time(stop)
                sp.set(device_ms=round(ms, 6))
                with _LOCK:
                    rec["device_ms"] = rec.get("device_ms", 0.0) + ms
            for seconds in (xprof.take_builds(library) if library else ()):
                REGISTRY.on_compile(rec, seconds, False)
                TR.event("prof.compile", site=site, key=kstr,
                         seconds=round(seconds, 6), aot=False)
    finally:
        with _LOCK:
            rec["dispatches"] += 1
    if capture:
        if count_flops and flops is None:
            flops = counter.get_total_flops()
        cap = xprof.capture_executable(site, args, outputs=call.outputs,
                                       flops=flops,
                                       bytes_accessed=bytes_accessed,
                                       library=library)
        with _LOCK:
            for k, v in cap.items():
                rec.setdefault(k, v)
            rec.setdefault("signature", "")
        TR.event("prof.executable", site=site, key=kstr, **{
            k: v for k, v in sorted(rec.items()) if k != "site"})


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def restore(snap: Optional[Dict[str, Any]]) -> None:
    REGISTRY.restore(snap)


def reset() -> None:
    REGISTRY.reset()


__all__ = ["ExecutableRegistry", "REGISTRY", "dispatch", "kernel",
           "key_str", "launched", "observed", "profiling", "reset",
           "restore", "snapshot", "unwatch", "watch", "watching"]
