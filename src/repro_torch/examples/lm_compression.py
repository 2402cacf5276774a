"""The paper's hardware-aware minimization applied to an LM, with the H100
roofline as the hardware cost.

Trains a tiny qwen3-family LM, then runs the NSGA-II search over per-matmul
(bits, block-sparsity, clusters) where the cost objective is the
*decode-step roofline seconds* on the H100 (`core.gpu_cost`) and the
accuracy objective is eval loss under the QAT forward (K5 at head_dim 32
runs its attention on the card). Prints the Pareto front: eval loss vs
projected decode latency.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_compression
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs import ARCHS, backend
from repro_torch.core import gpu_cost as GC
from repro_torch.core.compression_spec import ModelMin, qat_weight
from repro_torch.core.ga import GAConfig, run_nsga2
from repro_torch.core.pareto import pareto_front
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.dist.sharding import path_str
from repro_torch.nn import transformer as T
from repro_torch.roofline.hw import H100
from repro_torch.train import losses
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--population", type=int, default=12)
    ap.add_argument("--generations", type=int, default=5)
    args = ap.parse_args(argv)
    backend.configure()               # the REPRO_* knobs

    cfg = ARCHS["qwen3-0.6b"].reduced(vocab_size=512, d_model=128,
                                      num_heads=4, num_kv_heads=2,
                                      head_dim=32, d_ff=512)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, branching=4))

    print(f"pretraining the base LM ({args.steps} steps)...")
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    tr = Trainer(cfg, opt, TrainerConfig(total_steps=args.steps,
                                         log_every=40), pipe,
                 device=args.device)
    tr.run()
    params = tr.state.params
    dev = tr.device

    # compressible layer inventory (matmul weights >= 64x64)
    shapes = GC.lm_layer_shapes(params)
    names = sorted(shapes)
    print(f"{len(names)} compressible weight groups")

    eval_batch = {k: torch.as_tensor(v, device=dev)
                  for k, v in pipe.batch_at(9999).items()}

    @functools.lru_cache(maxsize=256)
    def eval_spec(spec_json: str) -> float:
        spec = ModelMin.from_json(spec_json)
        by_name = dict(zip(names, spec.layers))

        def leaf(path, w):
            nm = path_str(path)
            if nm in by_name and w.dim() >= 2:
                return qat_weight(w, by_name[nm])
            return w
        with torch.no_grad():
            qparams = T.map_tree(leaf, params)
            logits, aux = T.forward(qparams, eval_batch, cfg, remat=False)
            return float(losses.next_token_loss(logits, eval_batch["tokens"],
                                                aux=aux))

    def evaluate(spec: ModelMin):
        loss = eval_spec(spec.to_json())
        cost = GC.spec_cost_seconds([shapes[n] for n in names], spec,
                                    batch_tokens=1, hw=H100)["cost"]
        return (loss, cost * 1e6)          # (eval loss, decode us/token)

    base_spec = ModelMin.uniform(len(names))
    base_loss, base_cost = evaluate(base_spec)
    print(f"bf16 baseline: eval_loss={base_loss:.4f} "
          f"decode={base_cost:.4f} us/token (roofline, {H100.name})")

    res = run_nsga2(len(names), evaluate,
                    GAConfig(population=args.population,
                             generations=args.generations, seed=0),
                    seed_specs=[base_spec,
                                ModelMin.uniform(len(names), bits=8),
                                ModelMin.uniform(len(names), bits=4)])
    front = pareto_front(res.objectives)
    print(f"pareto front (eval_loss, decode us/token on {H100.name}, spec "
          f"of first layer):")
    order = np.argsort(res.objectives[front][:, 1])
    rows = []
    for i in np.asarray(front)[order][:8]:
        s = res.population[int(i)]
        rows.append((float(res.objectives[i, 0]),
                     float(res.objectives[i, 1])))
        print(f"  loss={res.objectives[i,0]:.4f} "
              f"decode={res.objectives[i,1]:7.4f}us  "
              f"L0={dataclasses.asdict(s.layers[0])}")
    best = front[np.argmin(res.objectives[front][:, 1])]
    speedup = base_cost / res.objectives[best, 1]
    print(f"max projected decode speedup at tolerable loss: "
          f"{speedup:.2f}x")
    return {"base_loss": base_loss, "base_cost_us": base_cost,
            "front": rows, "speedup": float(speedup),
            "n_groups": len(names)}


if __name__ == "__main__":
    main()
