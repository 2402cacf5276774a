"""Deterministic fault injection for the search runtime.

Nothing here touches wall-clock, signals or threads: every fault is
scheduled by (round, island) coordinates or by target spec, so a faulty
run is exactly reproducible and the recovery invariants — zero completed
evaluations lost, bit-identical resume — can be asserted, not eyeballed.

Fault classes covered (`tests/test_torch_search.py`):

* **straggle** — synthetic arrival times past the fleet deadline: the
  island is ejected for the round by `deadline_barrier`, its offspring
  budget redistributed.
* **kill_island** — :class:`IslandKilled` raised mid-generation (after the
  island committed its evaluations to the shared memo): permanent death,
  pure-function rollback.
* **eval faults** — exceptions raised from inside
  `batch_eval._compile_and_price`'s per-candidate attempt loop via the
  module's fault hook: one failing attempt exercises the retry, two the
  quarantine.
* **preempt_at** — the runtime flushes a checkpoint and raises
  `PreemptedError` after the given round, simulating a SIGTERM'd worker.
* **tear_cache_at** — the on-disk `EvalCache` JSON is truncated before the
  given round, simulating a crash mid-write; `EvalCache._read` salvages.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import batch_eval as BE
from repro_torch.search.islands import IslandKilled


# ---------------------------------------------------------------------------
# evaluation-exception injection (hooks into batch_eval's attempt loop)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvalFault:
    """Raise ``make_error()`` from inside candidate evaluation.

    ``spec_json`` — target spec (None = every spec); ``fail_attempts`` —
    how many attempts fail: 1 models a transient fault (the built-in retry
    absorbs it), >=2 a deterministic one (the spec quarantines).
    """
    spec_json: Optional[str] = None
    make_error: Callable[[], BaseException] = \
        lambda: OverflowError("injected: netlist sim budget exceeded")
    fail_attempts: int = 1


class _EvalFaultHook:
    def __init__(self, faults: List[EvalFault]):
        self.faults = list(faults)
        self.triggered: List[Tuple[str, int]] = []

    def __call__(self, spec, attempt: int) -> None:
        sj = spec.to_json()
        for f in self.faults:
            if f.spec_json is not None and sj != f.spec_json:
                continue
            if attempt <= f.fail_attempts:
                self.triggered.append((sj, attempt))
                raise f.make_error()


@contextlib.contextmanager
def inject_eval_faults(faults: List[EvalFault]):
    """Context manager installing the faults into `batch_eval`'s hook;
    yields the hook (``.triggered`` records every injected raise)."""
    hook = _EvalFaultHook(faults)
    prev = BE.set_eval_fault_hook(hook)
    try:
        yield hook
    finally:
        BE.set_eval_fault_hook(prev)


# ---------------------------------------------------------------------------
# fleet-level fault schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultPlan:
    # (round, island) -> synthetic arrival seconds (vs the fleet deadline)
    straggle: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    # island -> first round in which its worker dies mid-generation
    kill_island: Dict[int, int] = dataclasses.field(default_factory=dict)
    # request preemption after this round completes (checkpoint + raise)
    preempt_at: Optional[int] = None
    # truncate the EvalCache file just before this round starts
    tear_cache_at: Optional[int] = None
    tear_fraction: float = 0.5        # bytes kept


class FaultHarness:
    """The runtime-facing adapter for a :class:`FaultPlan`. Implements the
    duck-typed harness surface of `SearchRuntime` (arrival times, kill
    hook, preemption flag, before-round actions) and logs everything it
    injects."""

    def __init__(self, plan: FaultPlan, *, cache_path=None):
        self.plan = plan
        self.cache_path = Path(cache_path) if cache_path is not None else None
        self.log: List[Tuple] = []

    def arrival_time(self, island: int, round_idx: int) -> float:
        return float(self.plan.straggle.get((round_idx, island), 0.0))

    def island_kill_hook(self, island: int, round_idx: int) -> None:
        kill_round = self.plan.kill_island.get(island)
        if kill_round is not None and round_idx >= kill_round:
            self.log.append(("kill", island, round_idx))
            raise IslandKilled(
                f"fault harness: island {island} worker died "
                f"mid-generation in round {round_idx}")

    def preemption_requested(self, round_idx: int) -> bool:
        return (self.plan.preempt_at is not None
                and round_idx >= self.plan.preempt_at)

    def before_round(self, round_idx: int, runtime) -> None:
        if (self.plan.tear_cache_at == round_idx
                and self.cache_path is not None
                and self.cache_path.exists()):
            data = self.cache_path.read_bytes()
            keep = int(len(data) * self.plan.tear_fraction)
            self.cache_path.write_bytes(data[:keep])
            self.log.append(("tear_cache", round_idx, len(data), keep))


__all__ = ["EvalFault", "FaultHarness", "FaultPlan", "inject_eval_faults"]
