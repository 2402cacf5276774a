"""Checkpoint/resume runtime over the island fleet.

The full search state — per-island populations, RNG streams
(`random.Random.getstate()` Mersenne words stored as a checkpoint leaf),
generation counters, histories, the shared evaluation memo, fleet events
and quarantine records — is snapshotted through `ckpt.CheckpointManager`
(atomic tmp-dir rename, keep-N retention) on the
`dist.fault_tolerance.should_checkpoint_now` cadence, with an immediate
flush when the fault harness (or a real preemption notice) requests it.

`SearchRuntime.resume` restores the latest snapshot and continues; because
`ga_generation` consumes exactly the restored RNG stream and the restored
memo answers every already-done evaluation, the resumed search is
**bit-identical** to the uninterrupted one — the resume-equivalence tests
assert byte-equal Pareto fronts for kills at every round.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import ga as GA
from repro_torch.core.compression_spec import ModelMin
from repro_torch.core.pareto import pareto_front
from repro_torch.dist import fault_tolerance as FT
from repro_torch.obs import metrics as MT
from repro_torch.obs import prof as PF
from repro_torch.obs import trace as TR
from repro_torch.obs.ring import RingLog
from repro_torch.search.islands import IslandConfig, IslandFleet


class PreemptedError(RuntimeError):
    """The round loop was preempted after flushing a checkpoint. Callers
    resume with `SearchRuntime.resume(...)` — nothing is lost."""


@dataclasses.dataclass
class SearchConfig:
    n_layers: int
    rounds: int = 8                   # fleet-wide generations
    ga: GA.GAConfig = dataclasses.field(default_factory=GA.GAConfig)
    islands: IslandConfig = dataclasses.field(default_factory=IslandConfig)
    checkpoint_every: int = 0         # rounds; 0 = preemption-flush only
    keep: int = 3                     # CheckpointManager retention


@dataclasses.dataclass
class SearchResult:
    """Fleet-merged outcome: the Pareto front over EVERY evaluation any
    island ever completed (a dead island's work still counts)."""
    front_specs: List[ModelMin]
    front_objectives: np.ndarray      # (F, K), row-aligned with front_specs
    evaluations: Dict[str, Tuple[float, ...]]
    islands: List[GA.GAState]
    events: List[Dict]
    quarantined: List
    rounds: int


class SearchRuntime:
    """Drive an `IslandFleet` to `cfg.rounds` with checkpointing.

    ``harness`` (see `search.faults.FaultHarness`) is duck-typed:
    ``arrival_time(island, round)``, ``island_kill_hook(island, round)``,
    ``preemption_requested(round)``, ``before_round(round, runtime)``.
    ``eval_cache`` is flushed alongside every checkpoint so the on-disk
    evaluation store is at least as fresh as the search snapshot.
    Checkpoint writes are synchronous: search state is kilobytes, and a
    preemption flush must complete before the process dies.
    """

    def __init__(self, cfg: SearchConfig, *, evaluate=None,
                 batch_evaluate=None, ckpt_root=None, harness=None,
                 eval_cache=None,
                 seed_specs: Optional[List[ModelMin]] = None,
                 quarantine: Optional[List] = None):
        self.cfg = cfg
        self.harness = harness
        self.eval_cache = eval_cache
        self.mgr = (CheckpointManager(ckpt_root, keep=cfg.keep,
                                      async_write=False)
                    if ckpt_root is not None else None)
        self.fleet = IslandFleet(
            cfg.n_layers, cfg.ga, cfg.islands,
            evaluate=evaluate, batch_evaluate=batch_evaluate,
            seed_specs=seed_specs,
            timer=(harness.arrival_time if harness is not None else None),
            kill_hook=(harness.island_kill_hook if harness is not None
                       else None),
            quarantine=quarantine)

    # -- driving ------------------------------------------------------------

    def run(self) -> SearchResult:
        while self.fleet.round < self.cfg.rounds:
            r = self.fleet.round
            if self.harness is not None:
                self.harness.before_round(r, self)
            self.fleet.run_round()
            preempt = bool(self.harness is not None
                           and self.harness.preemption_requested(r))
            if self.mgr is not None and FT.should_checkpoint_now(
                    self.fleet.round, every=self.cfg.checkpoint_every,
                    preemption_requested=preempt):
                self.checkpoint()
            if preempt:
                TR.event("runtime.preempt", round=self.fleet.round,
                         checkpointed=self.mgr is not None)
                TR.flush()        # the process is about to die: drain now
                raise PreemptedError(
                    f"preempted after round {self.fleet.round} "
                    "(checkpoint flushed)" if self.mgr is not None else
                    f"preempted after round {self.fleet.round} "
                    "(NO checkpoint root configured)")
        return self.result()

    def result(self) -> SearchResult:
        fleet = self.fleet
        keys = sorted(fleet.evaluations)
        if keys:
            objs = np.asarray([fleet.evaluations[k] for k in keys], float)
            front = sorted(int(i) for i in pareto_front(objs))
            front_specs = [ModelMin.from_json(keys[i]) for i in front]
            front_objs = objs[front]
        else:
            front_specs, front_objs = [], np.zeros((0, 0))
        return SearchResult(front_specs, front_objs,
                            dict(fleet.evaluations),
                            [isl.state for isl in fleet.islands],
                            list(fleet.events), list(fleet.quarantine),
                            fleet.round)

    # -- checkpointing ------------------------------------------------------

    def checkpoint(self) -> None:
        if self.mgr is None:
            raise RuntimeError("no checkpoint root configured")
        # the metrics snapshot is packed BEFORE the write is accounted, so
        # the restored registry reflects exactly the counters at save time
        # (write timings live in histograms, outside the bit-identity
        # invariant — see repro.obs.metrics)
        tree, meta = self._pack()
        with TR.span("runtime.checkpoint", round=self.fleet.round) as sp:
            t0 = time.monotonic()
            self.mgr.save(self.fleet.round, tree, meta=meta)
            ms = (time.monotonic() - t0) * 1e3
            MT.histogram("ckpt.write_ms").observe(ms)
            if TR.active():
                step_dir = (self.mgr.root
                            / f"step_{self.fleet.round:08d}")
                nbytes = sum(f.stat().st_size
                             for f in step_dir.iterdir() if f.is_file())
                MT.histogram("ckpt.write_bytes").observe(nbytes)
                sp.set(bytes=nbytes, ms=round(ms, 3))
            if self.eval_cache is not None:
                self.eval_cache.flush()

    def _pack(self):
        islands = self.fleet.islands
        rngs, versions, gauss = [], [], []
        for isl in islands:
            version, internal, g = isl.state.rng_state
            # 624 Mersenne words + stream position, all < 2**32
            rngs.append(np.asarray(internal, np.uint64))
            versions.append(int(version))
            gauss.append(g)
        tree = {
            "rng": np.stack(rngs),
            "generation": np.asarray([isl.state.generation
                                      for isl in islands], np.int64),
        }
        meta = {
            "round": self.fleet.round,
            "populations": [[s.to_json() for s in isl.state.population]
                            for isl in islands],
            "history": [isl.state.history for isl in islands],
            "alive": [isl.alive for isl in islands],
            "ejections": [isl.ejections for isl in islands],
            "last_duration_s": [isl.last_duration_s for isl in islands],
            "rng_version": versions,
            "rng_gauss": gauss,
            "evaluations": {k: list(v)
                            for k, v in self.fleet.evaluations.items()},
            # rings persist their resident tail + true totals; the obs
            # trace (when on) holds the complete streams
            "events": list(self.fleet.events),
            "events_total": getattr(self.fleet.events, "total",
                                    len(self.fleet.events)),
            "quarantined": [dataclasses.asdict(q)
                            for q in self.fleet.quarantine],
            "quarantine_total": getattr(self.fleet.quarantine, "total",
                                        len(self.fleet.quarantine)),
            # the whole metrics registry rides along so resume() restores
            # monotone counters bit-identically
            "metrics": MT.snapshot(),
            # the executable observatory too: a resumed run keeps its
            # executable history (dispatch counts, captured cost/memory)
            # even though the fresh process rebuilds the executables
            "profile": PF.snapshot(),
        }
        return tree, meta

    @classmethod
    def resume(cls, cfg: SearchConfig, ckpt_root, *, evaluate=None,
               batch_evaluate=None, harness=None, eval_cache=None,
               quarantine: Optional[List] = None,
               step: Optional[int] = None) -> "SearchRuntime":
        """Rebuild a runtime from the latest (or ``step``) checkpoint.
        Continue with ``.run()`` — the continuation is bit-identical to the
        run that was killed."""
        mgr = CheckpointManager(ckpt_root, keep=cfg.keep, async_write=False)
        with TR.span("runtime.resume") as sp:
            tree, meta = mgr.restore(step, like={"rng": 0, "generation": 0})
            if tree is not None:
                sp.set(round=int(meta["round"]))
        if tree is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_root}")
        rt = cls(cfg, evaluate=evaluate, batch_evaluate=batch_evaluate,
                 ckpt_root=ckpt_root, harness=harness,
                 eval_cache=eval_cache, quarantine=quarantine)
        fleet = rt.fleet
        for i, isl in enumerate(fleet.islands):
            internal = tuple(int(x) for x in np.asarray(tree["rng"][i]))
            isl.state = GA.GAState(
                population=[ModelMin.from_json(s)
                            for s in meta["populations"][i]],
                rng_state=(int(meta["rng_version"][i]), internal,
                           meta["rng_gauss"][i]),
                generation=int(tree["generation"][i]),
                history=list(meta["history"][i]))
            isl.alive = bool(meta["alive"][i])
            isl.ejections = int(meta["ejections"][i])
            isl.last_duration_s = float(meta["last_duration_s"][i])
        fleet.round = int(meta["round"])
        fleet.evaluations = {k: tuple(v)
                             for k, v in meta["evaluations"].items()}
        fleet.events[:] = list(meta["events"])
        if isinstance(fleet.events, RingLog):
            fleet.events.total = int(meta.get("events_total",
                                              len(fleet.events)))
        # in-place so a caller-shared quarantine list (also wired into the
        # evaluator) keeps collecting into the same object
        fleet.quarantine[:] = [_record_from_dict(q)
                               for q in meta["quarantined"]]
        if isinstance(fleet.quarantine, RingLog):
            fleet.quarantine.total = int(meta.get(
                "quarantine_total", len(fleet.quarantine)))
        # restored counters are bit-identical to the values at save time:
        # the continuation increments from exactly where the dead run stood
        MT.restore(meta.get("metrics"))
        # executable registry restores dict-equal (checkpoints predating
        # the observatory restore to empty)
        PF.restore(meta.get("profile"))
        return rt


def _record_from_dict(d: Dict):
    from repro_torch.core.batch_eval import QuarantineRecord
    return QuarantineRecord(**d)


__all__ = ["PreemptedError", "SearchConfig", "SearchResult", "SearchRuntime"]
