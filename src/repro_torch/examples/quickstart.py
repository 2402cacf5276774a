"""Quickstart: the paper's pipeline end to end in about a minute.

Trains the Seeds printed-MLP classifier, applies each minimization technique
standalone, prices every design with the bespoke printed-circuit area model
(accuracy from the compiled netlist, simulated by kernel K1 on the card),
and prints the accuracy/area trade-off against the un-minimized baseline.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import backend
from repro_torch.configs.printed_mlp import SEEDS
from repro_torch.core import minimize as MZ
from repro_torch.core.compression_spec import ModelMin


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    backend.configure()               # the REPRO_* knobs
    dev = args.device
    n_layers = len(SEEDS.layer_dims) - 1

    print("1. un-minimized 8-bit bespoke baseline (Mubarik MICRO'20)")
    base = MZ.baseline(SEEDS, device=dev)
    print(f"   acc={base.accuracy:.3f} area={base.area_mm2/100:.1f} cm^2 "
          f"power={base.power_mw:.1f} mW mults={base.n_multipliers}")
    rows = {}
    steps = (
        ("2. quantization to 4 bits (QAT)", "q4",
         ModelMin.uniform(n_layers, bits=4)),
        ("3. unstructured pruning to 50% sparsity", "prune50",
         ModelMin.uniform(n_layers, bits=8, sparsity=0.5)),
        ("4. per-input weight clustering, k=4 (shared multipliers)",
         "cluster4", ModelMin.uniform(n_layers, bits=8, clusters=4)),
        ("5. all three combined (one GA candidate)", "combined",
         ModelMin.uniform(n_layers, bits=4, sparsity=0.3, clusters=6)),
    )
    for title, key, spec in steps:
        print(title)
        r = MZ.evaluate_spec(SEEDS, spec, device=dev)
        gain = base.area_mm2 / r.area_mm2
        rows[key] = {"accuracy": r.accuracy, "area_mm2": r.area_mm2,
                     "gain": gain, "n_multipliers": r.n_multipliers}
        print(f"   acc={r.accuracy:.3f} area={r.area_mm2/100:.1f} cm^2 "
              f"-> {gain:.2f}x smaller, mults={r.n_multipliers} "
              f"(vs {base.n_multipliers})")
    print("done. python -m repro_torch.paper runs the full hardware-aware "
          "GA.")
    return {"baseline": {"accuracy": base.accuracy,
                         "area_mm2": base.area_mm2,
                         "n_multipliers": base.n_multipliers},
            "techniques": rows}


if __name__ == "__main__":
    main()
