"""Ambient host-side tracing: nestable spans + structured events -> JSONL.

The switch mirrors the ``REPRO_VERIFY`` idiom (`repro_torch.verify.diagnostics`):
``REPRO_TRACE`` unset/0/false/off means *off*, and off is free — ``span()``
returns a shared no-op context manager and ``event()`` returns after one
module-global load. No file is opened, no line is formatted, zero extra
syscalls. Set ``REPRO_TRACE=1`` for the default ``repro_trace.jsonl`` in
the working directory, or ``REPRO_TRACE=/path/to/run.jsonl`` to choose the
file. In-process control (benchmarks, tests) goes through
:func:`start` / :func:`stop` / :func:`capture`.

Records are append-only JSONL, one complete record per line, buffered and
written whole-lines-at-a-time — the same torn-write-safety convention as
`batch_eval.EvalCache`: a crash tears at most the trailing line, and
:func:`read_trace` salvages every complete leading record (the damaged
tail is counted, not fatal).

Spans wrap host-side work and the *dispatch* of device work: PyTorch
returns before the card finishes, so a span around a CUDA call measures its
enqueue unless the body synchronises. The first call of a path that builds
something once (a kernel library, a cached pretrain) is marked via
:func:`first_call`, so reports can split that one-off cost from
steady-state execution.

Span records carry ``ts`` (seconds since the tracer's ``start_unix``,
monotonic clock), ``dur``, ``depth`` (per-thread nesting), ``attrs``, and
``error`` (exception class name) when the body raised — the span is
emitted either way and the exception propagates untouched.

A span has a second sink: while `torch.profiler` records (the
``torch.autograd.profiler._is_profiler_enabled`` flag), :func:`span` also
opens a range of the span's name in the profiler's trace, beside the
kernels it launches and on the profiler's clock, and :data:`SPANS` times
it on the device (:class:`SpanClock`). The range is a plain
``RecordFunction`` and not a ``record_function`` user annotation: Kineto
copies a user annotation onto the device's timeline as an interval of its
own, which a reader of device intervals would count as device work.
:func:`backward_span` times the backward pass of a region. Neither
sink on, :func:`span` returns a shared no-op after one global load and
one flag check; :func:`recording` is that test, and the model layer's
counters (`repro_torch.nn.moe`) gate on it too.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
# a range in the profiler's trace that Kineto does not copy onto the device
from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _AP

ENV_FLAG = "REPRO_TRACE"

# records buffered before a write: amortizes syscalls on hot search loops
# while keeping the torn tail at most one buffer deep on a crash
BUFFER_LINES = 256


class Tracer:
    """One open JSONL sink. Thread-safe; spans nest per thread."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._local = threading.local()
        self._seen_first: set = set()
        self.start_unix = time.time()
        self._t0 = time.monotonic()
        self.records = 0
        self._emit({"kind": "meta", "version": 1, "pid": os.getpid(),
                    "start_unix": self.start_unix})

    # -- record plumbing ---------------------------------------------------

    def now(self) -> float:
        return time.monotonic() - self._t0

    def _depth_stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            self._buf.append(line)
            self.records += 1
            if len(self._buf) >= BUFFER_LINES:
                self._drain()

    def _drain(self) -> None:
        # whole lines in one write: a torn write can only damage the tail
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._drain()
            self._f.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()

    def first(self, key) -> bool:
        with self._lock:
            if key in self._seen_first:
                return False
            self._seen_first.add(key)
            return True


class _NullSpan:
    """The off-path span: shared singleton, no state, no emission."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_t", "name", "attrs", "_start", "_depth", "_mark")

    def __init__(self, tracer: Optional[Tracer], name: str,
                 attrs: Dict[str, Any]):
        self._t = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attrs discovered mid-span (sizes, deltas)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        t = self._t
        if t is not None:
            st = t._depth_stack()
            self._depth = len(st)
            st.append(self.name)
            self._start = t.now()
        self._mark = SPANS.open(self.name) if _AP._is_profiler_enabled \
            else None
        return self

    def __exit__(self, etype, evalue, tb):
        if self._mark is not None:
            SPANS.close(self._mark)
        t = self._t
        if t is None:
            return False
        dur = t.now() - self._start
        st = t._depth_stack()
        if st and st[-1] == self.name:
            st.pop()
        rec = {"kind": "span", "name": self.name,
               "ts": round(self._start, 6), "dur": round(dur, 6),
               "depth": self._depth}
        if self.attrs:
            rec["attrs"] = self.attrs
        if etype is not None:
            rec["error"] = etype.__name__
        t._emit(rec)
        return False                        # exceptions propagate untouched


# ---------------------------------------------------------------------------
# the profiler's sink: ranges in its trace, device time by span
# ---------------------------------------------------------------------------


_streams = threading.local()


def _current_stream():
    """The thread's current CUDA stream, looked up again only when its
    handle changes: `torch.cuda.current_stream` costs more than an event's
    record under the profiler."""
    raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    held = getattr(_streams, "held", None)
    if held is None or held[0] != raw:
        held = _streams.held = (raw, torch.cuda.current_stream())
    return held[1]


def _clock():
    """A mark on the device's timeline: a CUDA event recorded on the
    current stream once CUDA is in use, else the host clock (CPU work is
    synchronous)."""
    if torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(_current_stream())
        return ev
    return time.perf_counter_ns()


def _elapsed(a, b) -> float:
    if isinstance(a, int):
        return (b - a) * 1e-9
    b.synchronize()
    return a.elapsed_time(b) * 1e-3


class _Mark:
    """One span's interval on the device, and the time of its children."""
    __slots__ = ("name", "parent", "range", "t0", "t1", "dur", "kids")

    def __init__(self, name: str, parent: Optional["_Mark"]):
        self.name, self.parent = name, parent
        self.range = self.t1 = None
        self.dur = self.kids = 0.0


class SpanClock:
    """Device time of the spans opened while the torch profiler records.

    Each span is timed between two marks on the device's timeline (CUDA
    events, nothing synchronised while it runs): from the moment the card
    reaches the span's first operation to the moment it finishes its last,
    which is the device time of the span's kernels where the card never
    waits for the host inside it. Spans nest per thread; a span's self
    time is its time less its children's. :meth:`totals` waits for the
    device to pass every closed span's end and folds them into per-name
    sums."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._closed: List[_Mark] = []
        self._totals: Dict[str, List[float]] = {}

    def _stack(self) -> List[_Mark]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str) -> _Mark:
        st = self._stack()
        m = _Mark(name, st[-1] if st else None)
        m.range = _Range(name)
        m.range.__enter__()
        m.t0 = _clock()
        st.append(m)
        return m

    def close(self, m: _Mark) -> None:
        m.t1 = _clock()
        st = self._stack()
        if st and st[-1] is m:
            st.pop()
        elif m in st:
            st.remove(m)
        m.range.__exit__(None, None, None)
        with self._lock:
            self._closed.append(m)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"calls", "s", "self_s", "root_s"}} over every span
        closed since the last :meth:`reset`, device seconds; ``root_s`` is
        the time of its calls inside no other span."""
        with self._lock:
            closed, self._closed = self._closed, []
            for m in closed:
                m.dur = _elapsed(m.t0, m.t1)
            for m in closed:        # a child closes before its parent
                if m.parent is not None:
                    m.parent.kids += m.dur
            for m in closed:
                acc = self._totals.setdefault(m.name, [0, 0.0, 0.0, 0.0])
                acc[0] += 1
                acc[1] += m.dur
                acc[2] += m.dur - m.kids
                if m.parent is None:
                    acc[3] += m.dur
            return {k: {"calls": int(v[0]), "s": v[1], "self_s": v[2],
                        "root_s": v[3]}
                    for k, v in sorted(self._totals.items())}

    def reset(self) -> None:
        with self._lock:
            self._closed.clear()
            self._totals.clear()


# the process-wide clock of the profiler's sink
SPANS = SpanClock()


class _BackwardMark(torch.autograd.Function):
    """Identity whose backward calls ``hook``: a boundary of a region's
    backward pass."""

    @staticmethod
    def forward(ctx, x, hook):
        ctx.hook = hook
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.hook()
        return g, None


class _BackwardSpan:
    __slots__ = ("name", "_mark")

    def __init__(self, name: str):
        self.name, self._mark = name, None

    def inputs(self, x):
        """Mark the region's input: its gradient closes the span."""
        return _BackwardMark.apply(x, self._close)

    def outputs(self, y):
        """Mark the region's output: its gradient opens the span."""
        return _BackwardMark.apply(y, self._open)

    def _open(self):
        if _AP._is_profiler_enabled:
            self._mark = SPANS.open(self.name)

    def _close(self):
        if self._mark is not None:
            SPANS.close(self._mark)
            self._mark = None


class _NullBackwardSpan:
    __slots__ = ()

    @staticmethod
    def inputs(x):
        return x

    @staticmethod
    def outputs(y):
        return y


_NULL_BACKWARD = _NullBackwardSpan()


def backward_span(name: str, x):
    """A span over the backward pass of a region whose input is ``x``:
    ``bw = backward_span(name, x); x = bw.inputs(x); ...; y =
    bw.outputs(y)``. It opens when the gradient reaches ``y`` and closes
    when it reaches ``x``, on the autograd engine's thread; work the
    backward pass runs again inside it (remat's recompute) is its
    children's, so its self time is the region's backward alone. Only
    while the torch profiler records and ``x`` takes a gradient, else a
    no-op that returns its arguments."""
    if not (_AP._is_profiler_enabled and x.requires_grad
            and torch.is_grad_enabled()):
        return _NULL_BACKWARD
    return _BackwardSpan(name)


# ---------------------------------------------------------------------------
# module-level switchboard
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None


def active() -> bool:
    """Is a tracer installed? The off-path is one global load."""
    return _tracer is not None


def recording() -> bool:
    """Does a span land anywhere: a JSONL tracer installed, or the torch
    profiler recording. One global load and one flag check."""
    return _tracer is not None or _AP._is_profiler_enabled


def start(path=None) -> Tracer:
    """Install a tracer (replacing any current one). ``path`` defaults to
    the ``REPRO_TRACE`` value when it names a file, else
    ``repro_trace.jsonl`` in the working directory."""
    global _tracer
    if path is None:
        path = default_path()
    stop()
    _tracer = Tracer(path)
    return _tracer


def stop() -> None:
    """Flush, close and uninstall the current tracer (no-op when off)."""
    global _tracer
    if _tracer is not None:
        t, _tracer = _tracer, None
        t.close()


def flush() -> None:
    if _tracer is not None:
        _tracer.flush()


def default_path() -> Path:
    v = os.environ.get(ENV_FLAG, "")
    if v and ("/" in v or v.endswith(".jsonl")):
        return Path(v)
    return Path("repro_trace.jsonl")


def span(name: str, **attrs):
    """Context manager timing one region: host-side into the JSONL tracer,
    and a range and device time while the torch profiler records.
    Zero-cost when neither is on."""
    t = _tracer
    if t is None and not _AP._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(t, name, attrs)


def event(name: str, **attrs) -> None:
    """One instant structured record (ledger entries, per-generation
    stats). Zero-cost when off."""
    t = _tracer
    if t is None:
        return
    rec: Dict[str, Any] = {"kind": "event", "name": name,
                           "ts": round(t.now(), 6)}
    if attrs:
        rec["attrs"] = attrs
    t._emit(rec)


def first_call(key) -> bool:
    """True exactly once per ``key`` per tracer — mark the call that
    includes a one-off build so reports split it from steady-state.
    Always False when tracing is off (nothing tracks, nothing pays)."""
    t = _tracer
    if t is None:
        return False
    return t.first(key)


class capture:
    """``with capture(path):`` — scoped tracer for tests/benchmarks;
    restores the previously-installed tracer (or off) on exit."""

    def __init__(self, path):
        self.path = Path(path)
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _tracer
        self._prev = _tracer
        if self._prev is not None:
            self._prev.flush()
        _tracer = Tracer(self.path)
        return _tracer

    def __exit__(self, *exc):
        global _tracer
        if _tracer is not None:
            _tracer.close()
        _tracer = self._prev
        return False


# ---------------------------------------------------------------------------
# reading traces back (salvaging torn tails)
# ---------------------------------------------------------------------------


def read_trace(path) -> Tuple[List[Dict[str, Any]], int]:
    """-> (records, damaged_line_count). Every complete leading line
    parses; undecodable lines (torn tail after a crash mid-write, or
    fault-injected truncation) are counted and skipped — mirroring
    `EvalCache`'s salvage-don't-die convention."""
    records: List[Dict[str, Any]] = []
    damaged = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                damaged += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                damaged += 1
    return records, damaged


def _ambient_init() -> None:
    v = os.environ.get(ENV_FLAG, "").lower()
    if v not in ("", "0", "false", "off"):
        start()
        atexit.register(stop)


_ambient_init()


__all__ = ["ENV_FLAG", "SPANS", "SpanClock", "Tracer", "active",
           "backward_span", "capture", "default_path", "event", "first_call",
           "flush", "read_trace", "recording", "span", "start", "stop"]
