"""The paper's hardware-aware search (Fig. 2) on the port, end to end.

`run` mirrors `benchmarks/fig2_combined.run`: pretrain the baseline, then
NSGA-II over bits x sparsity x clusters with every generation evaluated by
`core.batch_eval` (one batched QAT finetune on the card, one netlist-exact
simulation launch, one vectorized pricing pass), ending in the Pareto front
and the area gain at <=5% accuracy loss. Running the module mirrors steps
1-5 of `examples/printed_mlp_minimization.py`:

    PYTHONPATH=src python -m repro_torch.paper --dataset whitewine

(add ``--full`` for the paper-sized budget, ``--device cpu`` to run
without a card).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.printed_mlp import PRINTED_MLPS
from repro_torch.core import batch_eval as BE
from repro_torch.core import minimize as MZ
from repro_torch.core.compression_spec import ModelMin
from repro_torch.core.ga import GAConfig, run_nsga2
from repro_torch.core.pareto import gain_at_loss, pareto_front


def cache_path(cache_dir: str, dataset: str) -> str:
    """The port's EvalCache file: never the reference's ``_evals.json``."""
    return f"{cache_dir}/{dataset}_torch_evals.json"


def run(dataset: str = "whitewine", *, population=14, generations=7,
        epochs=90, seed=0, cache_dir: Optional[str] = None,
        netlist: bool = True, device: DeviceLike = None) -> Dict:
    """Accuracy is scored by default on the bit-exact simulation of each
    candidate's compiled circuit, the whole population per launch through
    `repro_torch.kernels.netlist_sim`; ``netlist=False`` opts out to the
    float emulation of the bespoke arithmetic."""
    dev = resolve_device(device)
    cfg = PRINTED_MLPS[dataset]
    base = MZ.baseline(cfg, seed=seed, device=dev)
    n_layers = len(cfg.layer_dims) - 1

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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
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
              device=dev,
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
    return res


if __name__ == "__main__":
    main()
