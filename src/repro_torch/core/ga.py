"""Hardware-aware NSGA-II genetic algorithm (paper Fig. 2).

Genome: one (bits, sparsity, clusters) gene per compressible layer.
Objectives (all minimized): (1 - accuracy, hardware cost[, ...]). The
evaluation callback is pluggable — printed area (mm^2) for the paper's
MLPs, roofline seconds (`core.tpu_cost`) for the beyond-paper LM
integration; "hardware-aware" means the GA sees the real deployment cost,
not a proxy. Evaluators may return more than two objectives (NSGA-II's
sorting/crowding are dimension-agnostic): the netlist-exact evaluator
(`batch_eval.make_batch_evaluator(netlist=True, include_delay=True)`)
adds the compiled circuit's critical-path delay as a third objective,
which the analytic cost model cannot express.

With ``csd_drop_choices`` / ``lsb_choices`` widened past ``(0,)`` the
genome also carries circuit-approximation genes (`repro.approx`, not ported yet): the GA
then trades bounded arithmetic error inside the bespoke netlist for area,
on top of the paper's quant/prune/cluster axes. Approximated candidates
are priced structurally and scored on the simulated approximate circuit
(`batch_eval` switches per candidate automatically).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression_spec import LayerMin, ModelMin
from repro_torch.core.pareto import crowding_distance, non_dominated_sort

BITS_CHOICES = (2, 3, 4, 5, 6, 7, 8)
SPARSITY_CHOICES = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)
CLUSTER_CHOICES = (None, 2, 3, 4, 6, 8, 12, 16)
# circuit-approximation genes (repro.approx, not ported yet). Off by default: the single
# (0,) choice draws nothing from the RNG, so exact searches reproduce
# their historical trajectories bit-for-bit.
CSD_DROP_CHOICES = (0, 1, 2, 3)
LSB_CHOICES = (0, 1, 2, 3, 4, 6)
ARGMAX_LSB_CHOICES = (0, 2, 4, 6, 8)


@dataclasses.dataclass
class GAConfig:
    population: int = 16
    generations: int = 8
    crossover_prob: float = 0.9
    mutation_prob: float = 0.25
    seed: int = 0
    input_bits: int = 8                  # propagated into random genomes
    bits_choices: Sequence = BITS_CHOICES
    sparsity_choices: Sequence = SPARSITY_CHOICES
    cluster_choices: Sequence = CLUSTER_CHOICES
    # set to CSD_DROP_CHOICES / LSB_CHOICES / ARGMAX_LSB_CHOICES (or your
    # own) to let the GA search bespoke-circuit approximation alongside
    # quant/prune/cluster
    csd_drop_choices: Sequence = (0,)
    lsb_choices: Sequence = (0,)
    argmax_lsb_choices: Sequence = (0,)   # model-level gene (one comparator)

    @property
    def approx_enabled(self) -> bool:
        return tuple(self.csd_drop_choices) != (0,) \
            or tuple(self.lsb_choices) != (0,) \
            or tuple(self.argmax_lsb_choices) != (0,)


@dataclasses.dataclass
class GAResult:
    population: List[ModelMin]
    objectives: np.ndarray               # (N, K>=2) minimized
    history: List[Dict]                  # per-generation stats
    evaluations: Dict[str, Tuple[float, ...]]  # spec json -> objectives
    # specs whose evaluation failed (retried once, then given worst-case
    # fitness) — `batch_eval.QuarantineRecord`s with the stage/error that
    # sank them; empty on clean runs
    quarantined: List = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GAState:
    """Resumable NSGA-II state between generations.

    ``rng_state`` is the exact ``random.Random.getstate()`` tuple, so a
    search advanced one :func:`ga_generation` at a time consumes the same
    RNG stream as the monolithic :func:`run_nsga2` loop — checkpointed and
    resumed searches are bit-identical to uninterrupted ones.
    """
    population: List[ModelMin]
    rng_state: Tuple
    generation: int = 0
    history: List[Dict] = dataclasses.field(default_factory=list)


def _random_gene(rng, cfg: GAConfig) -> LayerMin:
    g = LayerMin(bits=rng.choice(cfg.bits_choices),
                 sparsity=rng.choice(cfg.sparsity_choices),
                 clusters=rng.choice(cfg.cluster_choices))
    if cfg.approx_enabled:               # extra draws only when searching
        g = dataclasses.replace(g,
                                csd_drop=rng.choice(cfg.csd_drop_choices),
                                lsb=rng.choice(cfg.lsb_choices))
    return g


def _mutate(spec: ModelMin, rng, cfg: GAConfig) -> ModelMin:
    fields = ["bits", "sparsity", "clusters"]
    if cfg.approx_enabled:
        fields += ["csd_drop", "lsb"]
    genes = list(spec.layers)
    for i, g in enumerate(genes):
        if rng.random() < cfg.mutation_prob:
            field = rng.choice(fields)
            if field == "bits":
                genes[i] = dataclasses.replace(g, bits=rng.choice(cfg.bits_choices))
            elif field == "sparsity":
                genes[i] = dataclasses.replace(
                    g, sparsity=rng.choice(cfg.sparsity_choices))
            elif field == "clusters":
                genes[i] = dataclasses.replace(
                    g, clusters=rng.choice(cfg.cluster_choices))
            elif field == "csd_drop":
                genes[i] = dataclasses.replace(
                    g, csd_drop=rng.choice(cfg.csd_drop_choices))
            else:
                genes[i] = dataclasses.replace(
                    g, lsb=rng.choice(cfg.lsb_choices))
    argmax_lsb = spec.argmax_lsb
    if cfg.approx_enabled and rng.random() < cfg.mutation_prob:
        argmax_lsb = rng.choice(cfg.argmax_lsb_choices)
    return ModelMin(tuple(genes), spec.input_bits, argmax_lsb)


def _crossover(a: ModelMin, b: ModelMin, rng) -> ModelMin:
    genes = tuple(ga if rng.random() < 0.5 else gb
                  for ga, gb in zip(a.layers, b.layers))
    # the model-level gene recombines 50/50 like the per-layer ones; the
    # draw happens only when the parents disagree, so exact searches
    # (argmax_lsb always 0) keep their historical RNG stream
    am = a.argmax_lsb
    if a.argmax_lsb != b.argmax_lsb and rng.random() < 0.5:
        am = b.argmax_lsb
    return ModelMin(genes, a.input_bits, am)


def _tournament(idx_ranked: List[int], rng) -> int:
    i, j = rng.sample(range(len(idx_ranked)), 2)
    return idx_ranked[min(i, j)]


def _ranked_with_fronts(objs: np.ndarray):
    fronts = non_dominated_sort(objs)
    ranked: List[int] = []
    for f in fronts:
        if len(f) == 0:
            continue
        cd = crowding_distance(objs[f])
        ranked.extend(int(i) for i in f[np.argsort(-cd)])
    return ranked, fronts


def rank_population(objs: np.ndarray) -> List[int]:
    """Population indices best-first: non-domination rank, crowding-distance
    tiebreak — the ordering NSGA-II's tournament selection sees. Exposed for
    the island fleet (elite selection for migration uses the same ranking)."""
    return _ranked_with_fronts(objs)[0]


def init_ga_state(n_layers: int, cfg: GAConfig,
                  seed_specs: Optional[List[ModelMin]] = None) -> GAState:
    """Generation-0 state: seed specs + random genomes, RNG stream exported.
    Byte-identical population to `run_nsga2`'s initialisation."""
    rng = random.Random(cfg.seed)
    # propagate input_bits into random genomes: seed specs win, else config
    input_bits = seed_specs[0].input_bits if seed_specs else cfg.input_bits
    pop: List[ModelMin] = list(seed_specs or [])
    while len(pop) < cfg.population:
        genes = tuple(_random_gene(rng, cfg) for _ in range(n_layers))
        # the model-level gene is sampled at init like the per-layer ones
        # (drawn only when approximation is searched: exact configs keep
        # their historical RNG stream)
        am = (rng.choice(cfg.argmax_lsb_choices) if cfg.approx_enabled
              else 0)
        pop.append(ModelMin(genes, input_bits, am))
    return GAState(pop, rng.getstate())


def ga_generation(state: GAState, cfg: GAConfig,
                  fit_all: Callable[[List[ModelMin]], np.ndarray], *,
                  n_children: Optional[int] = None) -> GAState:
    """One NSGA-II generation as a PURE function: rank, breed, mu+lambda
    select. Returns a new state; the input state is never mutated, so a
    caller that catches an exception from `fit_all` (worker death, injected
    fault) rolls back for free by simply keeping the old state.

    ``n_children`` overrides the offspring count for this generation only
    (default ``cfg.population`` — the `run_nsga2` behaviour); the island
    fleet uses it to deal an ejected island's offspring budget over the
    survivors. Selection pressure is unchanged: the environmental selection
    still keeps the best ``cfg.population`` of parents+children.
    """
    rng = random.Random()
    rng.setstate(state.rng_state)
    pop = list(state.population)
    if n_children is None:
        n_children = cfg.population
    objs = fit_all(pop)
    ranked, fronts = _ranked_with_fronts(objs)
    entry = {
        "generation": state.generation,
        "best_acc": float(1.0 - objs[:, 0].min()),
        "min_cost": float(objs[:, 1].min()),
        "front_size": int(len(fronts[0])),
    }
    if objs.shape[1] > 2:          # netlist-exact delay objective
        entry["min_delay"] = float(objs[:, 2].min())
    # offspring
    children: List[ModelMin] = []
    while len(children) < n_children:
        pa, pb = pop[_tournament(ranked, rng)], pop[_tournament(ranked, rng)]
        child = _crossover(pa, pb, rng) if rng.random() < cfg.crossover_prob else pa
        children.append(_mutate(child, rng, cfg))
    # mu + lambda environmental selection
    union = pop + children
    uobjs = fit_all(union)
    ufronts = non_dominated_sort(uobjs)
    new_pop: List[ModelMin] = []
    for f in ufronts:
        if len(new_pop) + len(f) <= cfg.population:
            new_pop.extend(union[int(i)] for i in f)
        else:
            cd = crowding_distance(uobjs[f])
            order = f[np.argsort(-cd)]
            for i in order:
                if len(new_pop) >= cfg.population:
                    break
                new_pop.append(union[int(i)])
            break
    return GAState(new_pop, rng.getstate(), state.generation + 1,
                   [*state.history, entry])


def run_nsga2(n_layers: int,
              evaluate: Optional[Callable[[ModelMin], Tuple[float, float]]],
              cfg: Optional[GAConfig] = None,
              seed_specs: Optional[List[ModelMin]] = None, *,
              batch_evaluate: Optional[
                  Callable[[List[ModelMin]], List[Tuple[float, float]]]]
              = None,
              on_generation: Optional[Callable[[GAState], None]] = None,
              quarantine: Optional[List] = None) -> GAResult:
    """evaluate(spec) -> (obj1, obj2[, ...]), all minimized (every spec
    must return the same arity). Deterministic for a fixed GAConfig.seed.
    Memoizes repeated specs.

    When `batch_evaluate` is given (e.g. `batch_eval.make_batch_evaluator`),
    every generation's uncached specs are fitted in ONE call — the batched
    engine runs the whole population's QAT finetune at once instead of N
    sequential finetunes.

    ``on_generation`` is called with the new :class:`GAState` after every
    generation — the checkpointing hook (`repro.search.runtime` snapshots
    state there; any exception aborts the search with state intact).
    ``quarantine``: pass the same list given to
    `batch_eval.make_batch_evaluator(quarantine=...)` and the records of
    specs that failed evaluation surface on ``GAResult.quarantined``.
    """
    if evaluate is None and batch_evaluate is None:
        raise ValueError("need evaluate or batch_evaluate")
    if cfg is None:
        cfg = GAConfig()
    cache: Dict[str, Tuple[float, float]] = {}

    def fit_all(specs: List[ModelMin]) -> np.ndarray:
        todo, seen = [], set()
        for s in specs:
            k = s.to_json()
            if k not in cache and k not in seen:
                todo.append(s)
                seen.add(k)
        if todo:
            if batch_evaluate is not None:
                outs = batch_evaluate(todo)
            else:
                outs = [evaluate(s) for s in todo]
            for s, o in zip(todo, outs):
                cache[s.to_json()] = tuple(map(float, o))
        return np.array([cache[s.to_json()] for s in specs])

    state = init_ga_state(n_layers, cfg, seed_specs)
    for _ in range(cfg.generations):
        state = ga_generation(state, cfg, fit_all)
        if on_generation is not None:
            on_generation(state)

    objs = fit_all(state.population)
    return GAResult(state.population, objs, state.history, cache,
                    quarantined=list(quarantine) if quarantine else [])
