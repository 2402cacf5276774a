"""Straggler / failure handling for the synchronous training loop.

Synchronous data parallelism moves at the pace of the slowest host. The
policy here is deadline-based ejection: hosts that miss the step deadline
are dropped from the step and their share of the global batch is
redistributed over the survivors, so throughput degrades gracefully
instead of stalling the whole pod behind one bad VM.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def deadline_barrier(arrival_times_s: Sequence[float],
                     deadline_s: float) -> List[bool]:
    """Which hosts made the barrier: True = arrived within the deadline and
    participates in this step, False = straggler, ejected for the step."""
    return [float(t) <= float(deadline_s) for t in arrival_times_s]


def redistribute_batch(global_batch: int, alive: Sequence[bool]
                       ) -> Dict[int, int]:
    """Deal `global_batch` examples over the alive hosts (dead hosts get 0).
    Shares differ by at most 1; the sum is exactly `global_batch`."""
    alive_ids = [i for i, ok in enumerate(alive) if ok]
    if not alive_ids:
        raise RuntimeError("no alive hosts to redistribute the batch onto")
    base, rem = divmod(int(global_batch), len(alive_ids))
    deal = {i: 0 for i in range(len(alive))}
    for j, h in enumerate(alive_ids):
        deal[h] = base + (1 if j < rem else 0)
    return deal


def should_checkpoint_now(step: int, *, every: int,
                          preemption_requested: bool) -> bool:
    """Checkpoint cadence + immediate flush on a preemption notice."""
    return preemption_requested or (every > 0 and step % every == 0)
