"""Fault-tolerant island-model search runtime, the port of `repro.search`
(the same classes, names, events, counters and checkpoint contents).

`islands` — N NSGA-II islands with independent RNG streams, periodic elite
migration, deadline-based straggler ejection (`dist.fault_tolerance`) and a
shared evaluation memo over the flock-merged on-disk `EvalCache`.
`runtime` — checkpoint/resume of the whole fleet via `ckpt.CheckpointManager`;
a resumed search is bit-identical to the uninterrupted one.
`faults` — deterministic fault-injection harness (island kills, evaluation
exceptions, simulated preemption, cache tearing) for the recovery tests.
"""
from repro_torch.search.faults import (EvalFault, FaultHarness, FaultPlan,
                                       inject_eval_faults)
from repro_torch.search.islands import (Island, IslandConfig, IslandFleet,
                                        IslandKilled)
from repro_torch.search.runtime import (PreemptedError, SearchConfig,
                                        SearchResult, SearchRuntime)

__all__ = ["EvalFault", "FaultHarness", "FaultPlan", "Island",
           "IslandConfig", "IslandFleet", "IslandKilled", "PreemptedError",
           "SearchConfig", "SearchResult", "SearchRuntime",
           "inject_eval_faults"]
