"""A traced stretch of a run: `torch.profiler` over a few steps, reduced in
memory (nothing is written to disk) to what the per-layer metrics read.

`Summary` holds the device's intervals (kernels, copies and fills), the
host's operations, and the stretch's wall time from the host clock between
two synchronizations. The device is busy where any interval covers the
time; idle gaps are named by the innermost host operation (an ATen op or a
``bench.*`` range of the drivers) that covers the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

TOP = 10
NAME_CHARS = 160
SCAN = 4096          # host ops looked back over for a gap's name
RANGE = "bench."     # the drivers' host ranges


class Summary:
    def __init__(self, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]], window_s: float):
        self.device = sorted(device, key=lambda e: e[1])   # (name, t0, t1) ns
        self.host = host
        self.window_s = window_s
        self._busy = _union([(a, b) for _, a, b in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-9

    def kernel_s(self, match) -> float:
        """Seconds of the device intervals whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-9

    def kernel_count(self, match=None) -> int:
        return sum(1 for n, _, _ in self.device
                   if match is None or match(n))

    def device_ops(self) -> List[list]:
        tot: Dict[str, int] = defaultdict(int)
        for n, a, b in self.device:
            tot[n[:NAME_CHARS]] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, v * 1e-9] for n, v in top]

    def idle_gaps(self) -> List[list]:
        """Idle time between device intervals, summed by what the host was
        doing in the middle of each gap; the largest ten. The innermost host
        op covering a time is the latest-started one that has not ended."""
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        tot: Dict[str, int] = defaultdict(int)
        for (_, b), (a, _) in zip(self._busy, self._busy[1:]):
            mid = (a + b) // 2
            name = "host: outside any op"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - SCAN), -1):
                if host[j][2] >= mid:
                    name = host[j][0][:NAME_CHARS]
                    break
            tot[name] += a - b
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, v * 1e-9] for n, v in top]


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _events(prof):
    """(device intervals, host ops) as (name, start ns, end ns)."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
        rows = ((e.name(), e.device_type(), e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in events)
    except AttributeError:
        rows = ((e.name, e.device_type, int(e.time_range.start * 1000),
                 int(e.time_range.end * 1000)) for e in prof.events())
    for name, kind, a, b in rows:
        if kind == cuda:
            # the device-side copy of a host range (a user annotation)
            # spans the whole step and is no device work
            if not name.startswith(RANGE):
                dev.append((name, a, b))
        elif not name.startswith(("cuda", "cu", "Memcpy")):
            host.append((name, a, b))
    return dev, host


@contextlib.contextmanager
def traced(device: torch.device, out: list):
    """Profile the body; append its `Summary` to ``out`` on exit."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    out.append(Summary(dev, host, window))


def step_range(name: str):
    """A named host range, so that idle gaps can be laid at a step's door."""
    return torch.profiler.record_function(RANGE + name)
