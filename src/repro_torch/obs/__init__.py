"""Search-runtime observability: ambient tracing, metrics, the executable
observatory and run reports, all zero-cost when off (the ``REPRO_TRACE``
idiom, mirroring ``REPRO_VERIFY``).

* `repro_torch.obs.trace` — nestable host-side spans and structured
  events, appended as torn-write-safe JSONL;
* `repro_torch.obs.metrics` — the process-wide counter/gauge/histogram
  registry, snapshotted into every search checkpoint and restored
  bit-identically on resume;
* `repro_torch.obs.prof` / `repro_torch.obs.xprof` — the executable
  observatory: a process-wide registry of the port's dispatch sites
  (analytic or counted FLOPs and bytes on the first dispatch, ``nvcc``
  builds as compiles, CUDA-event times, per-key dispatch counts),
  snapshotted into every search checkpoint like the metrics registry;
* `repro_torch.obs.report` — ``python -m repro_torch.obs.report
  trace.jsonl`` renders wall-clock breakdowns, per-island timelines,
  Pareto progress, cache-hit curves, the executables/padding sections and
  the fault/quarantine ledger (plus CSVs).

`repro_torch.obs.ring.RingLog` is the bounded in-memory event log the
search runtime uses so long runs spill their full event stream to the trace
instead of growing lists without bound.

The trace, metrics, ring and report modules are copies of `repro.obs`'s
with the same flag, span, counter and event names, so one report reads
either package's trace.
"""
from repro_torch.obs import metrics, prof, xprof
from repro_torch.obs.ring import RingLog
from repro_torch.obs.trace import (active, capture, event, first_call,
                                   read_trace, span, start, stop)

__all__ = ["RingLog", "active", "capture", "event", "first_call",
           "metrics", "prof", "read_trace", "span", "start", "stop",
           "xprof"]
