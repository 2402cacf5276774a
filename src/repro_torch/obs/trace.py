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
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

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
    __slots__ = ("_t", "name", "attrs", "_start", "_depth")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._t = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attrs discovered mid-span (sizes, deltas)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = self._t._depth_stack()
        self._depth = len(st)
        st.append(self.name)
        self._start = self._t.now()
        return self

    def __exit__(self, etype, evalue, tb):
        dur = self._t.now() - self._start
        st = self._t._depth_stack()
        if st and st[-1] == self.name:
            st.pop()
        rec = {"kind": "span", "name": self.name,
               "ts": round(self._start, 6), "dur": round(dur, 6),
               "depth": self._depth}
        if self.attrs:
            rec["attrs"] = self.attrs
        if etype is not None:
            rec["error"] = etype.__name__
        self._t._emit(rec)
        return False                        # exceptions propagate untouched


# ---------------------------------------------------------------------------
# module-level switchboard
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None


def active() -> bool:
    """Is a tracer installed? The off-path is one global load."""
    return _tracer is not None


def tracing_to() -> Optional[Path]:
    return _tracer.path if _tracer is not None else None


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
    """Context manager timing one host-side region. Zero-cost when off."""
    t = _tracer
    if t is None:
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


__all__ = ["ENV_FLAG", "Tracer", "active", "capture", "default_path",
           "event", "first_call", "flush", "read_trace", "span", "start",
           "stop", "tracing_to"]
