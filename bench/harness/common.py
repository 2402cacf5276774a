"""What every driver shares: the run's context, its outcome, the manifest
(`BENCHMARK.json`), the per-layer metric readers, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level modules that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    workload: str
    spec: Any                      # reference.spec.ModelSpec
    mix: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any                    # torch.device
    t_start: float                 # process start, perf_counter
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    faults: frozenset = frozenset()    # planted faults (the fault tests)
    control: bool = False              # read the control's numbers too


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]              # end-to-end metrics of the window
    attempted: int
    failed: int
    checks: Dict[str, float]           # numbers compared, by name
    obs: Dict[str, Any]                # readings for the per-layer readers
    memory_peak_bytes: int
    control: Dict[str, float] = dataclasses.field(default_factory=dict)


def log(ctx: Context, msg: str) -> None:
    """A progress line on standard error, seconds since the process
    started."""
    import time
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits (``bench/limits/<workload>.json``): number name ->
    the largest sound value."""
    return load_json(BENCH / "limits" / f"{workload}.json")["limits"]


def reader(name: str):
    """The per-layer metric's module, ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share q of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(checks: Dict[str, float], lim: Dict[str, float]) -> bool:
    """Correct when every number with a limit is there, finite and at or
    under its limit. A number read without a limit is printed, not
    compared."""
    if not lim or set(lim) - set(checks):
        return False
    return all(math.isfinite(checks[name]) and checks[name] <= lim[name]
               for name in lim)


def result_line(out: Outcome, metrics: Dict[str, dict], device: dict,
                lim: Dict[str, float], breakdown: Optional[dict]) -> dict:
    line = {"correct": judge(out.checks, lim), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim.get(k)}
                      for k, v in out.checks.items()}
    return line
