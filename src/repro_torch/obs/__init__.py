"""Search-runtime observability: ambient tracing and metrics, both
zero-cost when off (the ``REPRO_TRACE`` idiom, mirroring ``REPRO_VERIFY``).

* `repro_torch.obs.trace` — nestable host-side spans and structured
  events, appended as torn-write-safe JSONL;
* `repro_torch.obs.metrics` — the process-wide counter/gauge/histogram
  registry.

Both are stdlib-only copies of `repro.obs.{trace,metrics}` with the same
flag, span and counter names, so one report reads either package's trace.
"""
from repro_torch.obs import metrics
from repro_torch.obs.trace import (active, capture, event, first_call,
                                   read_trace, span, start, stop)

__all__ = ["active", "capture", "event", "first_call", "metrics",
           "read_trace", "span", "start", "stop"]
