"""Netlist approximation subsystem: pass-based circuit transforms with
interval worst-case error bounds, searched by the GA (a copy of
`repro.approx`; only `measure` simulates, on an explicit ``device``).

Built on the circuit IR (`repro_torch.circuit`): passes rebuild the
netlist (widths/levels re-derived by construction), the analyzer turns
local rewrite annotations + TRUNC semantics into per-logit worst-case
error bounds, and `circuit.cost.structural_cost` prices the approximated
circuit (TRUNC-aware width discounts) where the analytic `hw_model`
cannot.

* `repro_torch.approx.rewrite` — rebuild walk, Pass / PassManager, DCE
* `repro_torch.approx.passes`  — RoundCoeffsCSD / TruncateAccum /
                                 SimplifyActs
* `repro_torch.approx.analyze` — interval error propagation + logit
                                 bounds (pure Python ints: no numpy, no
                                 torch)
* `repro_torch.approx.measure` — simulation-measured counterparts of the
                                 bounds
* `repro_torch.approx.budget`  — ApproxParams, greedy `fit_budget` under a
                                 user-supplied logit-error budget

Quick use::

    net, compiled = circuit.compile_spec(cfg, spec, epochs=60)
    budget = approx.logit_budget(net, 0.01)          # 1% of logit range
    params, anet, rep = approx.fit_budget(net, budget)
    acc = circuit.netlist_accuracy(anet, compiled, xte, yte)
    print(rep.area_gain, rep.bound)                  # proven error ceiling

The GA searches the same knobs as genes: `LayerMin.csd_drop` / `.lsb` and
`ModelMin.argmax_lsb` (see `core.ga` / `core.batch_eval`).
"""
from repro_torch.approx import (analyze, budget, measure,  # noqa: F401
                                passes, rewrite)
from repro_torch.approx.analyze import (decision_error_bound,  # noqa: F401
                                        logit_error_bound,
                                        propagate_errors)
from repro_torch.approx.measure import measured_max_logit_error  # noqa: F401
from repro_torch.approx.budget import (ApproxParams,  # noqa: F401
                                       BudgetReport, approximate,
                                       build_passes, evaluate_netlist,
                                       fit_budget, logit_budget)
from repro_torch.approx.passes import (RoundCoeffsCSD,  # noqa: F401
                                       SimplifyActs, TruncateAccum,
                                       product_info, truncate_csd)
from repro_torch.approx.rewrite import (Pass, PassManager,  # noqa: F401
                                        rebuild)
