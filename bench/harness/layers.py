"""The program's own spans and counters, read after a traced stretch.

While `torch.profiler` records, the port opens spans at its model layer's
boundaries (`repro_torch.obs.trace`: ``lm.block``, ``lm.dequant``,
``lm.mla.attend``, ``lm.moe.*``, ``lm.head``, ``train.optimizer``), each a
range in the profiler's trace and timed on the device by the port
(`trace.SPANS`, CUDA events), and the MoE counts its routed, kept and
capacity pairs (`repro_torch.obs.metrics`). Nothing else records in a
benchmark run, so what the port holds after the traced stretch is that
stretch's. The per-layer readers of those spans and counters read them
here; a port without them gives None, and so do the readers.

This module and `bench.harness.program` are the harness's two that import
the port; this one imports only its `obs` package.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, Optional

# the port's span names: the model layer's and the optimizer's
PROGRAM = ("lm.", "train.")
# the drivers' host range of one step or request (bench.harness.trace)
STEP = {"decode": "bench.decode_step", "prefill": "bench.prefill_step",
        "train": "bench.train_step"}
# program spans looked back over for a gap's innermost one (a block opens
# a few dozen)
SCAN = 256
_logged: set = set()


def span_times() -> Optional[Dict[str, Dict[str, float]]]:
    """{span: {"calls", "s", "self_s"}} in device seconds, or None where
    the port times no span."""
    from repro_torch.obs import trace as TR
    spans = getattr(TR, "SPANS", None)
    return None if spans is None else spans.totals()


def counters() -> Dict[str, int]:
    from repro_torch.obs import metrics as MT
    return MT.snapshot()["counters"]


def steps(tr, kind: str) -> int:
    """The traced steps (requests) of a ``kind`` cell: its drivers' host
    ranges in the trace."""
    return sum(1 for name, _, _ in tr.host if name == STEP[kind])


def _traced(obs, kind: str):
    tr = obs.get("trace")
    if obs.get("kind") != kind or tr is None:
        return None
    return tr


def span_ms(obs, kind: str, span: str, own: bool = False) -> Optional[float]:
    """Milliseconds of ``span`` on the device a traced step of a ``kind``
    cell (its self time with ``own``), or None where it did not run."""
    tr = _traced(obs, kind)
    times = span_times() if tr is not None else None
    n = steps(tr, kind) if tr is not None else 0
    if not times or span not in times or not n:
        return None
    log_idle_by_span(tr, times)
    return 1e3 * times[span]["self_s" if own else "s"] / n


def counted(obs, kind: str, *names: str):
    """The counters ``names`` of the traced stretch of a ``kind`` cell, or
    None where the port counts none of them."""
    if _traced(obs, kind) is None:
        return None
    c = counters()
    if any(n not in c for n in names):
        return None
    return [c[n] for n in names]


def idle_by_span(tr) -> Dict[str, float]:
    """Idle seconds of the traced stretch by the innermost program span
    the host was in at each gap's middle (``host: outside any span``
    where none)."""
    spans = sorted((e for e in tr.host if e[0].startswith(PROGRAM)),
                   key=lambda e: e[1])
    starts = [e[1] for e in spans]
    busy = tr._busy
    out: Dict[str, float] = defaultdict(float)
    for (_, b), (a, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        name = "host: outside any span"
        # the innermost span covering mid: the latest-started one not ended
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - SCAN), -1):
            if spans[j][2] >= mid:
                name = spans[j][0]
                break
        out[name] += (a - b) * 1e-9
    return dict(out)


def outside_s(tr, times, idle: Dict[str, float]) -> float:
    """Device-busy seconds of the stretch in no program span: the busy
    time less the outermost spans' device time, itself less the idle time
    inside them (a span's two CUDA events take in the card's waits)."""
    covered = sum(t.get("root_s", 0.0) for t in times.values())
    waits = sum(v for n, v in idle.items() if n.startswith(PROGRAM))
    return tr.busy_s - (covered - waits)


def log_idle_by_span(tr, times) -> None:
    """Once a stretch, to standard error: its idle seconds by program
    span, the device seconds of each span, and the busy seconds in no
    span."""
    if id(tr) in _logged:
        return
    _logged.add(id(tr))
    idle = idle_by_span(tr)
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    print("program spans: idle s by innermost span "
          + ", ".join(f"{n} {v:.6f}" for n, v in ranked[:10]),
          file=sys.stderr)
    print("program spans: device s by span (all, self) "
          + ", ".join(f"{n} {t['s']:.6f} {t['self_s']:.6f}"
                      for n, t in times.items()),
          file=sys.stderr)
    out = outside_s(tr, times, idle)
    print(f"program spans: busy {tr.busy_s:.6f} s of window "
          f"{tr.window_s:.6f} s; in no span {out:.6f} s "
          f"({100.0 * out / tr.busy_s if tr.busy_s else 0.0:.3f}%)",
          file=sys.stderr)
