"""Island-model NSGA-II fleet with straggler ejection and kill rollback.

N islands each advance an independent NSGA-II population (`core.ga`'s
stepped API — per-island `random.Random` streams seeded `cfg.seed + i`),
sharing one evaluation memo so no spec is ever fitted twice fleet-wide;
plug `batch_eval.make_batch_evaluator(cache=EvalCache(...))` in as the
evaluator and the memo extends across processes through the flock-merged
on-disk cache.

Fault model (all per *round* — one round = one generation on every
participating island):

* **Stragglers**: before each round every island reports an arrival time
  (by default its previous round's measured duration, host wall time; the
  fault harness injects synthetic ones). On the card that duration covers
  work really done, not queued launches: the evaluator copies the trained
  weights to the host (`nn.mlp.params_to_numpy`) and reads K1's result
  back inside the round, and both synchronize the stream. `dist.fault_tolerance.deadline_barrier` ejects
  islands past ``deadline_s`` for the round — their state is simply not
  advanced — and `redistribute_batch` deals their offspring budget over
  the participants, so fleet-wide selection throughput is preserved
  instead of the whole fleet stalling behind one slow worker.
* **Kills**: an evaluation transport that raises :class:`IslandKilled`
  mid-generation (worker death) marks the island permanently dead. Because
  `ga_generation` is a pure function, rollback is free — the island keeps
  its last committed state, and every evaluation it published before dying
  stays in the shared memo (zero completed evaluations lost).
* **Migration**: every ``migration_every`` rounds each live island's top
  ``migrants`` (non-domination rank, crowding tiebreak) replace the worst
  members of its ring neighbour. Deterministic — no RNG draws — so the
  islands' genetic streams are untouched by migration topology.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import ga as GA
from repro_torch.core.compression_spec import ModelMin
from repro_torch.core.pareto import pareto_front
from repro_torch.dist import fault_tolerance as FT
from repro_torch.obs import metrics as MT
from repro_torch.obs import trace as TR
from repro_torch.obs.ring import RingLog


class IslandKilled(RuntimeError):
    """Raised from inside an island's generation (by the fault harness, or
    by a real worker transport) to signal the worker died mid-generation.
    The fleet rolls the island back to its last committed state and marks
    it dead; the survivors keep searching."""


@dataclasses.dataclass
class IslandConfig:
    n_islands: int = 4
    migration_every: int = 2          # rounds between migrations; 0 = never
    migrants: int = 2                 # elites copied to the ring neighbour
    deadline_s: float = float("inf")  # per-round straggler deadline
    redistribute_offspring: bool = True
    # in-memory caps for the fleet event / quarantine logs: only the newest
    # N stay resident (the full streams spill to the obs trace when
    # REPRO_TRACE is on) — a week-long run can't grow the process without
    # bound. `RingLog.total`/`.dropped` keep the true counts.
    event_buffer: int = 1024
    quarantine_buffer: int = 1024


@dataclasses.dataclass
class Island:
    index: int
    cfg: GA.GAConfig                  # per-island (seed = fleet seed + index)
    state: GA.GAState
    alive: bool = True                # False once killed — permanent
    ejections: int = 0                # rounds skipped as a straggler
    last_duration_s: float = 0.0      # measured; default arrival time


class IslandFleet:
    """The island fleet. Construct, then call :meth:`run_round` until
    satisfied (`search.runtime.SearchRuntime` adds checkpoint/resume and
    the result assembly on top)."""

    def __init__(self, n_layers: int, ga_cfg: GA.GAConfig,
                 icfg: Optional[IslandConfig] = None, *,
                 evaluate=None, batch_evaluate=None,
                 seed_specs: Optional[List[ModelMin]] = None,
                 timer: Optional[Callable[[int, int], float]] = None,
                 kill_hook: Optional[Callable[[int, int], None]] = None,
                 quarantine: Optional[List] = None):
        if evaluate is None and batch_evaluate is None:
            raise ValueError("need evaluate or batch_evaluate")
        self.icfg = icfg or IslandConfig()
        self.evaluate = evaluate
        self.batch_evaluate = batch_evaluate
        self.timer = timer or self._default_timer
        self.kill_hook = kill_hook
        # seed specs go to island 0 only: duplicating them fleet-wide would
        # start every island in the same basin
        self.islands = [
            Island(i, cfg_i := dataclasses.replace(ga_cfg, seed=ga_cfg.seed + i),
                   GA.init_ga_state(n_layers, cfg_i,
                                    seed_specs if i == 0 else None))
            for i in range(self.icfg.n_islands)]
        self.evaluations: Dict[str, Tuple[float, ...]] = {}
        self.round = 0
        # bounded in memory; every append also lands in the obs trace (the
        # JSONL is the complete stream, the ring is the working set)
        self.events: RingLog = RingLog(
            self.icfg.event_buffer,
            spill=lambda e: TR.event(
                "fleet." + (e.get("event", "event")
                            if isinstance(e, dict) else "event"),
                **(e if isinstance(e, dict) else {"item": e})))
        # shared with the evaluator (`make_batch_evaluator(quarantine=...)`)
        # so failing specs surface on the final SearchResult; callers may
        # pass their own (possibly unbounded) list and keep old behaviour
        self.quarantine = (quarantine if quarantine is not None
                           else RingLog(self.icfg.quarantine_buffer))

    # -- evaluation ---------------------------------------------------------

    def _fit_specs(self, specs: List[ModelMin]) -> np.ndarray:
        todo, seen = [], set()
        for s in specs:
            k = s.to_json()
            if k not in self.evaluations and k not in seen:
                todo.append(s)
                seen.add(k)
        MT.counter("fleet.specs_requested").inc(len(specs))
        MT.counter("fleet.specs_memoized").inc(len(specs) - len(todo))
        MT.counter("fleet.specs_fitted").inc(len(todo))
        TR.event("fleet.fit", round=self.round, requested=len(specs),
                 memoized=len(specs) - len(todo), fitted=len(todo))
        if todo:
            outs = (self.batch_evaluate(todo) if self.batch_evaluate
                    else [self.evaluate(s) for s in todo])
            for s, o in zip(todo, outs):
                self.evaluations[s.to_json()] = tuple(map(float, o))
        return np.array([self.evaluations[s.to_json()] for s in specs])

    def _island_fit(self, isl: Island):
        def fit(specs):
            objs = self._fit_specs(specs)
            # the kill hook fires AFTER the results are committed to the
            # shared memo — modelling a worker that published its
            # evaluations and died before finishing selection
            if self.kill_hook is not None:
                self.kill_hook(isl.index, self.round)
            return objs
        return fit

    def _default_timer(self, island_index: int, round_idx: int) -> float:
        return self.islands[island_index].last_duration_s

    # -- rounds -------------------------------------------------------------

    def run_round(self) -> None:
        r = self.round
        if not any(isl.alive for isl in self.islands):
            raise RuntimeError("island fleet: every island is dead")
        with TR.span("fleet.round", round=r):
            self._run_round_inner(r)
        MT.counter("fleet.rounds").inc()
        if (self.icfg.migration_every
                and self.round % self.icfg.migration_every == 0):
            self._migrate()

    def _run_round_inner(self, r: int) -> None:
        times = [self.timer(isl.index, r) if isl.alive else float("inf")
                 for isl in self.islands]
        made = FT.deadline_barrier(times, self.icfg.deadline_s)
        participate = [m and isl.alive
                       for m, isl in zip(made, self.islands)]
        if not any(participate):
            # every live island straggled: waive the deadline for the round
            # rather than deadlock the fleet behind its own barrier
            participate = [isl.alive for isl in self.islands]
            self.events.append({"round": r, "event": "all_straggle_waived"})
        # deal the non-participants' per-round offspring budget over the
        # participants: fleet-wide selection throughput survives ejections
        extra = sum(isl.cfg.population
                    for isl, p in zip(self.islands, participate) if not p)
        if extra and self.icfg.redistribute_offspring:
            deal = FT.redistribute_batch(extra, participate)
        else:
            deal = {i: 0 for i in range(len(self.islands))}
        for isl, p in zip(self.islands, participate):
            if not p:
                if isl.alive:
                    isl.ejections += 1
                    MT.counter("island.ejections").inc()
                    self.events.append(
                        {"round": r, "island": isl.index,
                         "event": "straggler_ejected",
                         "arrival_s": float(times[isl.index])})
                continue
            t0 = time.monotonic()
            try:
                with TR.span("island.generation", island=isl.index,
                             round=r, generation=isl.state.generation):
                    isl.state = GA.ga_generation(
                        isl.state, isl.cfg, self._island_fit(isl),
                        n_children=isl.cfg.population + deal[isl.index])
                MT.counter("island.generations").inc()
                self._trace_front(isl, r)
            except IslandKilled as e:
                # pure-function rollback: state was never touched; its
                # published evaluations stay in the shared memo
                isl.alive = False
                MT.counter("island.kills").inc()
                self.events.append({"round": r, "island": isl.index,
                                    "event": "killed", "error": str(e)})
            isl.last_duration_s = time.monotonic() - t0
        self.round += 1

    def _trace_front(self, isl: Island, r: int) -> None:
        """Per-generation front stats into the trace (tracing-only: the
        rank over memoized objectives is recomputed here, never drawn from
        the RNG, so trajectories are identical with tracing on or off)."""
        if not TR.active():
            return
        h = isl.state.history[-1] if isl.state.history else {}
        objs = np.asarray([self.evaluations[s.to_json()]
                           for s in isl.state.population], float)
        # first front only, vectorized — the generic per-pair
        # non_dominated_sort would tax every traced generation
        first = pareto_front(objs)
        front = [[round(float(v), 6) for v in objs[int(i)]] for i in first]
        TR.event("ga.front", island=isl.index, round=r,
                 generation=isl.state.generation,
                 best_acc=h.get("best_acc"), min_cost=h.get("min_cost"),
                 front_size=len(front), front=front)

    # -- migration ----------------------------------------------------------

    def _migrate(self) -> None:
        alive = [isl for isl in self.islands if isl.alive]
        m = self.icfg.migrants
        if len(alive) < 2 or m <= 0:
            return
        # all ranks computed on pre-migration populations (simultaneous
        # exchange); populations are post-generation, so every member is
        # already in the shared memo — no new evaluations here
        ranked = {isl.index: GA.rank_population(
            self._fit_specs(isl.state.population)) for isl in alive}
        staged: Dict[int, List[ModelMin]] = {}
        for pos, src in enumerate(alive):
            dst = alive[(pos + 1) % len(alive)]
            elite = [src.state.population[j] for j in ranked[src.index][:m]]
            newpop = list(dst.state.population)
            # worst-ranked members of the receiver make room for the elites
            for slot, spec in zip(reversed(ranked[dst.index]), elite):
                newpop[slot] = spec
            staged[dst.index] = newpop
        for isl in alive:
            if isl.index in staged:
                isl.state = dataclasses.replace(isl.state,
                                                population=staged[isl.index])
        MT.counter("fleet.migrations").inc()
        MT.counter("fleet.migrants_accepted").inc(m * len(staged))
        self.events.append({"round": self.round, "event": "migration",
                            "migrants": m, "islands": len(alive)})
