"""Process-wide metrics registry: counters, gauges, histograms.

Metrics are pure in-memory arithmetic — no file, no syscall, ever — so
the registry is always on (unlike tracing, which owns a file handle and
hides behind ``REPRO_TRACE``). The cost of an un-exported counter is one
dict lookup and an integer add.

Determinism contract (the checkpoint/resume invariant):

* **counters** hold exact Python ints and count *deterministic* search
  quantities (specs evaluated/memoized, cache hits, quarantines by stage,
  ejections, migrations). `search.runtime.SearchRuntime` snapshots the
  registry into every checkpoint and ``resume()`` restores it, so a
  preempted+resumed search finishes with counters **bit-identical** to the
  uninterrupted run's (tested). A counter may also take a 0-dim tensor
  increment (a count the device computed, such as the MoE's kept
  routing pairs): it stays on the device, nothing waits for it, and it is
  folded into the exact int with one ``.item()`` when the value is read.
* **gauges** and **histograms** may hold wall-clock and byte sizes
  (checkpoint write ms/bytes, flush times) — real measurements that
  legitimately differ between a preempted and an uninterrupted run. They
  are snapshotted and restored too, but excluded from the bit-identity
  invariant.

Snapshot layout (JSON-able, keys sorted — byte-stable for equal states)::

    {"counters": {name: int},
     "gauges":   {name: float},
     "histograms": {name: {"count": int, "sum": float,
                            "min": float, "max": float}}}
"""
from __future__ import annotations

import numbers
import threading
from typing import Dict, Optional

_LOCK = threading.Lock()


# device increments a counter holds before it sums them on the device
PENDING_MAX = 1024


class Counter:
    """Monotone integer counter. ``inc`` takes an int, or a 0-dim integer
    tensor that is held where it lives and folded into ``value`` on read."""
    __slots__ = ("_value", "_pending")

    def __init__(self):
        self._value = 0
        self._pending: list = []

    def inc(self, n=1) -> None:
        if isinstance(n, numbers.Integral):
            self._value += int(n)
            return
        self._pending.append(n)
        if len(self._pending) >= PENDING_MAX:   # summed on the device, no wait
            self._pending = [_device_sum(self._pending)]

    @property
    def value(self) -> int:
        if self._pending:
            pending, self._pending = self._pending, []
            self._value += int(_device_sum(pending).item())
        return self._value

    @value.setter
    def value(self, v: int) -> None:
        self._pending = []
        self._value = int(v)


def _device_sum(ts: list):
    import torch
    return torch.stack([t.reshape(()) for t in ts]).sum()


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary (count/sum/min/max) — enough for overhead and
    size accounting without bucket-boundary bikeshedding."""
    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Named metric store. Get-or-create accessors; snapshot/restore are
    the checkpoint surface."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with _LOCK:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with _LOCK:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with _LOCK:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()

    # -- checkpoint surface --------------------------------------------------

    def snapshot(self) -> Dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: {"count": h.count, "sum": h.sum,
                               "min": h.min, "max": h.max}
                           for k, h in sorted(self._histograms.items())},
        }

    def restore(self, snap: Optional[Dict]) -> None:
        """Replace state with a snapshot's — exact, so restored counters
        are bit-identical to the values at save time. Tolerates missing
        sections (checkpoints predating the obs layer restore to empty)."""
        self.reset()
        if not snap:
            return
        for k, v in snap.get("counters", {}).items():
            self.counter(k).value = int(v)
        for k, v in snap.get("gauges", {}).items():
            self.gauge(k).value = float(v)
        for k, d in snap.get("histograms", {}).items():
            h = self.histogram(k)
            h.count = int(d["count"])
            h.sum = float(d["sum"])
            h.min = None if d["min"] is None else float(d["min"])
            h.max = None if d["max"] is None else float(d["max"])


# the process-wide registry: search/eval code increments through these
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def restore(snap: Optional[Dict]) -> None:
    REGISTRY.restore(snap)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "restore", "snapshot"]
