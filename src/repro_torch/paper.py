"""The paper's figures on the port, end to end.

`run` mirrors `benchmarks/fig2_combined.run` (Fig. 2): pretrain the
baseline, then NSGA-II over bits x sparsity x clusters — with
``approx=True`` also the circuit-approximation genes — with every
generation evaluated by `core.batch_eval` (one batched QAT finetune on the
card, one netlist-exact simulation launch for the exact candidates, one
for each approximated one, one vectorized pricing pass), ending in the
Pareto front and the area gain at <=5% accuracy loss. `fig1` mirrors
`benchmarks/fig1_standalone.run` (Fig. 1): the three standalone-technique
sweeps per dataset. Running the module mirrors
`examples/printed_mlp_minimization.py`, step 6 (the budgeted circuit
approximation of the chosen point) included:

    PYTHONPATH=src python -m repro_torch.paper --dataset whitewine

(add ``--full`` for the paper-sized budget, ``--approx`` to search the
approximation genes too, ``--device cpu`` to run without a card).
"""
from __future__ import annotations

import argparse
import time
import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import backend
from repro_torch.configs.printed_mlp import PRINTED_MLPS
from repro_torch.core import batch_eval as BE
from repro_torch.core import minimize as MZ
from repro_torch.core.compression_spec import ModelMin
from repro_torch.core.ga import (ARGMAX_LSB_CHOICES, CSD_DROP_CHOICES,
                                 LSB_CHOICES, GAConfig, run_nsga2)
from repro_torch.core.pareto import gain_at_loss, pareto_front


def cache_path(cache_dir: str, dataset: str) -> str:
    """The port's EvalCache file: never the reference's ``_evals.json``."""
    return f"{cache_dir}/{dataset}_torch_evals.json"


def run(dataset: str = "whitewine", *, population=14, generations=7,
        epochs=90, seed=0, cache_dir: Optional[str] = None,
        netlist: bool = True, approx: bool = False,
        device: DeviceLike = None) -> Dict:
    """Accuracy is scored by default on the bit-exact simulation of each
    candidate's compiled circuit, the whole population per launch through
    `repro_torch.kernels.netlist_sim`; ``netlist=False`` opts out to the
    float emulation of the bespoke arithmetic. ``approx=True`` additionally
    lets the GA search the circuit-approximation genes
    (`repro_torch.approx`: truncated-CSD coefficients, accumulator LSB
    truncation, comparator narrowing) and forces netlist-exact accuracy so
    exact and approximated candidates compete on the same
    simulated-datapath objective."""
    dev = resolve_device(device)
    cfg = PRINTED_MLPS[dataset]
    base = MZ.baseline(cfg, seed=seed, device=dev)
    n_layers = len(cfg.layer_dims) - 1
    netlist = netlist or approx

    cache = BE.EvalCache(cache_path(cache_dir, dataset)) if cache_dir \
        else None
    record: Dict[str, MZ.EvalResult] = {}
    batch_evaluate = BE.make_batch_evaluator(cfg, epochs=epochs, seed=seed,
                                             cache=cache, netlist=netlist,
                                             record=record, device=dev)

    # warm start from the best standalone configs, at the dataset's input
    # width (run_nsga2 propagates it into every random genome)
    ib = cfg.input_bits
    seeds = [ModelMin.uniform(n_layers, bits=4, input_bits=ib),
             ModelMin.uniform(n_layers, bits=3, sparsity=0.3, input_bits=ib),
             ModelMin.uniform(n_layers, bits=4, sparsity=0.4, clusters=8,
                              input_bits=ib)]
    ga_cfg = GAConfig(population=population, generations=generations,
                      seed=seed, input_bits=cfg.input_bits)
    if approx:
        ga_cfg = dataclasses.replace(ga_cfg,
                                     csd_drop_choices=CSD_DROP_CHOICES,
                                     lsb_choices=LSB_CHOICES,
                                     argmax_lsb_choices=ARGMAX_LSB_CHOICES)
        # warm-start the approximation axis from the minimized seed
        seeds.append(ModelMin.uniform(n_layers, bits=4, sparsity=0.4,
                                      clusters=8, csd_drop=1, lsb=2,
                                      input_bits=ib))
    res = run_nsga2(n_layers, None, ga_cfg, seed_specs=seeds,
                    batch_evaluate=batch_evaluate)
    pts = [(1.0 - o[0], o[1]) for o in res.objectives]
    gain = gain_at_loss(pts, baseline_acc=base.accuracy,
                        baseline_area=base.area_mm2, max_loss=0.05)
    front_idx = pareto_front(res.objectives)
    front = [(round(pts[i][0], 4), round(pts[i][1], 1),
              record[res.population[i].to_json()].delay_levels,
              res.population[i].to_json()) for i in front_idx]
    return {
        "dataset": dataset,
        "device": str(dev),
        "baseline_acc": round(base.accuracy, 4),
        "baseline_area_mm2": round(base.area_mm2, 1),
        "combined_gain_at_5pct": round(gain, 2),
        "pareto_front": front,
        "history": res.history,
        "n_evaluations": len(res.evaluations),
        "evaluations": res.evaluations,      # spec json -> objective tuple
    }


def fig1(datasets: Optional[Sequence[str]] = None, epochs: int = 150, *,
         device: DeviceLike = None) -> Dict:
    """Fig. 1: the accuracy-area points of the three STANDALONE techniques
    (quantization 2-7 bits, pruning 20-60%, clustering 2-8 clusters per
    input row), each point one serial `evaluate_spec` as in
    `benchmarks/fig1_standalone.run`, normalized to the un-minimized 8-bit
    bespoke baseline, with each technique's area gain at <=5% loss.
    ``datasets`` defaults to all four."""
    dev = resolve_device(device)
    out: Dict[str, Dict] = {}
    for name in datasets or list(PRINTED_MLPS):
        cfg = PRINTED_MLPS[name]
        base = MZ.baseline(cfg, device=dev)
        sweeps = {
            "quantization": MZ.quant_sweep(cfg, range(2, 8), epochs=epochs,
                                           device=dev),
            "pruning": MZ.prune_sweep(cfg, (0.2, 0.3, 0.4, 0.5, 0.6),
                                      epochs=epochs, device=dev),
            "clustering": MZ.cluster_sweep(cfg, (2, 3, 4, 6, 8),
                                           epochs=epochs, device=dev),
        }
        rows = {}
        for tech, results in sweeps.items():
            pts = [(r.accuracy, r.area_mm2) for r in results]
            gain = gain_at_loss(pts, baseline_acc=base.accuracy,
                                baseline_area=base.area_mm2, max_loss=0.05)
            rows[tech] = {
                "points": [(round(a, 4), round(ar, 1)) for a, ar in pts],
                "gain_at_5pct": round(gain, 2),
            }
        out[name] = {
            "baseline_acc": round(base.accuracy, 4),
            "baseline_area_mm2": round(base.area_mm2, 1),
            "techniques": rows,
        }
    return out


def chosen_point(res: Dict) -> str:
    """The cheapest front member within 5% accuracy loss of the baseline
    (the paper's max-gain operating point), else the most accurate one."""
    eligible = [(acc, area, spec) for acc, area, _, spec
                in res["pareto_front"]
                if acc >= res["baseline_acc"] - 0.05]
    if eligible:
        return min(eligible, key=lambda t: t[1])[2]
    return max(res["pareto_front"], key=lambda t: t[0])[3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="whitewine",
                    choices=sorted(PRINTED_MLPS))
    ap.add_argument("--full", action="store_true",
                    help="paper-sized budget (slower)")
    ap.add_argument("--cache-dir", default=".eval_cache",
                    help="persistent evaluation cache dir")
    ap.add_argument("--approx", action="store_true",
                    help="also search the circuit-approximation genes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    backend.configure()               # the REPRO_* knobs
    dev = resolve_device(args.device)

    cfg = PRINTED_MLPS[args.dataset]
    n_layers = len(cfg.layer_dims) - 1
    epochs = 90 if args.full else 60
    cache = BE.EvalCache(cache_path(args.cache_dir, cfg.name))

    # -- 1. baseline ------------------------------------------------------
    t0 = time.time()
    base = MZ.baseline(cfg, device=dev)
    print(f"[{cfg.name}] baseline (dense 8-bit bespoke) on {dev}: "
          f"acc={base.accuracy:.3f} area={base.area_mm2/100:.1f} cm2 "
          f"power={base.power_mw:.1f} mW "
          f"({base.n_multipliers} multipliers)  [{time.time()-t0:.0f}s]")

    # -- 2. Fig. 1 slice: quantization sweep as one batched call ----------
    t0 = time.time()
    sweep = [ModelMin.uniform(n_layers, bits=b, input_bits=cfg.input_bits)
             for b in range(2, 8)]
    results = BE.evaluate_population(cfg, sweep, epochs=epochs, cache=cache,
                                     device=dev)
    print(f"quantization sweep (one batched call, {len(sweep)} specs, "
          f"{time.time()-t0:.0f}s):")
    for r in results:
        gain = base.area_mm2 / max(r.area_mm2, 1e-9)
        print(f"  {r.spec.layers[0].bits}-bit: acc={r.accuracy:.3f} "
              f"area={r.area_mm2/100:6.2f} cm2 ({gain:.1f}x)")

    # -- 3. Fig. 2: hardware-aware GA through the batched engine ----------
    t0 = time.time()
    res = run(args.dataset, cache_dir=args.cache_dir, epochs=epochs,
              approx=args.approx, device=dev,
              **({} if args.full else dict(population=8, generations=3)))
    print(f"GA search: {res['n_evaluations']} unique evaluations in "
          f"{time.time()-t0:.0f}s (cache: {args.cache_dir})")

    # -- 4. report --------------------------------------------------------
    print(f"combined gain at <=5% accuracy loss: "
          f"{res['combined_gain_at_5pct']:.2f}x (paper: up to ~8x)")
    print("pareto front (acc, area cm2, critical path, spec):")
    for acc, area, delay, spec in res["pareto_front"][:8]:
        print(f"  acc={acc:.3f} area={area/100:7.2f} cm2 "
              f"delay={delay:3d} stages  {spec}")

    # -- 5. compile the chosen point to an actual bespoke circuit ---------
    from repro_torch import circuit
    chosen = chosen_point(res)
    net, compiled = circuit.compile_spec(cfg, ModelMin.from_json(chosen),
                                         epochs=epochs, device=dev)
    _, _, xte, yte = MZ.dataset_for(cfg)
    sc = circuit.structural_cost(net)
    cv = circuit.cross_validate(net, compiled)
    acc_exact = circuit.netlist_accuracy(net, compiled, xte, yte, device=dev)
    print(f"\ncompiled circuit for the chosen point {chosen}:")
    print(circuit.describe(net, sc))
    print(f"netlist-exact accuracy: {acc_exact:.3f} "
          f"(float emulation: {MZ.compiled_accuracy(compiled, xte, yte):.3f})")
    print(f"structural cost == analytic hw_model: {cv['ok']}")

    # -- 6. approximate the circuit itself under an error budget ----------
    # beyond minimization: the approx pass pipeline (truncated-CSD
    # coefficients, accumulator LSB truncation, comparator narrowing)
    # greedily trades PROVEN worst-case logit error for area
    from repro_torch import approx
    budget = approx.logit_budget(net, 0.01)       # 1% of the logit range
    _, anet, rep = approx.fit_budget(net, budget)
    acc_approx = circuit.netlist_accuracy(anet, compiled, xte, yte,
                                          device=dev)
    asc = circuit.structural_cost(anet)
    print(f"\napproximated under a {budget}-LSB logit-error budget "
          f"(proven bound: {rep.bound}):")
    print(f"  knobs: {rep.params}")
    print(f"  area {sc.area_mm2/100:.2f} -> {asc.area_mm2/100:.2f} cm2 "
          f"({rep.area_gain:.2f}x on top of minimization), "
          f"accuracy {acc_exact:.3f} -> {acc_approx:.3f}")
    return res


if __name__ == "__main__":
    main()
