"""Greedy budgeted application of the approximation passes.

`ApproxParams` is the full knob vector (per-layer CSD digit drops, per-layer
accumulator LSB truncations, argmax comparator truncation) — the same genes
`compression_spec` carries for the GA. `fit_budget` raises knobs one step
at a time, re-running the pass pipeline from the exact netlist and keeping
a step only while the interval analyzer's worst-case decision-error bound
stays within the user's logit-error budget — so the returned circuit comes
with a *proof* of its maximum logit deviation, not just a measured one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch import DeviceLike
from repro_torch.circuit import cost as COST
from repro_torch.circuit import ir
from repro_torch.approx.analyze import (decision_error_bound,
                                        logit_error_bound)
from repro_torch.approx.passes import (RoundCoeffsCSD, SimplifyActs,
                                       TruncateAccum)
from repro_torch.approx.rewrite import PassManager


@dataclasses.dataclass(frozen=True)
class ApproxParams:
    """Per-layer approximation knobs; all-zero is the identity."""
    csd_drop: Tuple[int, ...]
    lsb: Tuple[int, ...]
    argmax_lsb: int = 0

    @staticmethod
    def zero(n_layers: int) -> "ApproxParams":
        return ApproxParams((0,) * n_layers, (0,) * n_layers, 0)

    @staticmethod
    def from_spec(spec) -> "ApproxParams":
        """Lift the approximation genes out of a `ModelMin`."""
        return ApproxParams(tuple(l.csd_drop for l in spec.layers),
                            tuple(l.lsb for l in spec.layers),
                            spec.argmax_lsb)

    @property
    def is_identity(self) -> bool:
        return (not any(self.csd_drop) and not any(self.lsb)
                and self.argmax_lsb == 0)


def build_passes(p: ApproxParams) -> List:
    """Pass pipeline for a knob vector. Coefficient rounding runs first
    (it rebuilds the multiplier subnets), LSB truncation wraps the rebuilt
    roots, activation/comparator simplification runs last. The all-zero
    vector yields an empty (identity) pipeline — any *approximated*
    candidate gets SimplifyActs, so its exact ReLU elision (which fires
    only where provably error-free) applies uniformly rather than riding
    on the argmax knob alone."""
    out = []
    if any(p.csd_drop):
        out.append(RoundCoeffsCSD(p.csd_drop))
    if any(p.lsb):
        out.append(TruncateAccum(p.lsb))
    if not p.is_identity:
        out.append(SimplifyActs(p.argmax_lsb))
    return out


def approximate(net: ir.Netlist, p: ApproxParams) -> ir.Netlist:
    """Apply the knob vector to an exact netlist. Identity knobs still run
    the (empty) PassManager — bit-exact, cost-exact (tested)."""
    return PassManager(build_passes(p)).run(net)


def evaluate_netlist(net: ir.Netlist, compiled, spec, xte, yte, *,
                     device: DeviceLike = None):
    """THE scoring policy for a candidate carrying approximation genes,
    shared by the serial (`minimize.evaluate_spec`) and batched
    (`batch_eval._compile_and_price`) paths so they can never drift: the
    printed circuit is the approximated netlist, so accuracy is its
    bit-exact simulation (one K1 launch on ``device``, CUDA unless
    ``"cpu"``), area/power the approximation-aware structural pricing,
    delay its critical path. ``net`` is the candidate's EXACT compiled
    netlist. Returns a `minimize.EvalResult`."""
    from repro_torch.circuit.simulate import netlist_accuracy
    from repro_torch.core import minimize as MZ  # lazy: minimize imports us

    anet = approximate(net, ApproxParams.from_spec(spec))
    sc = COST.structural_cost(anet)
    return MZ.EvalResult(spec, netlist_accuracy(anet, compiled, xte, yte,
                                                device=device),
                         sc.area_mm2, sc.power_mw, sc.n_multipliers,
                         delay_levels=anet.critical_path_levels())


def logit_budget(net: ir.Netlist, frac: float) -> int:
    """Absolute logit-error budget as a fraction of the circuit's largest
    worst-case logit magnitude — a scale-free way to say 'x% of the logit
    range' across datasets and specs."""
    mag = max((max(abs(net.nodes[i].lo), abs(net.nodes[i].hi))
               for i in net.output_ids), default=0)
    return max(int(frac * mag), 0)


@dataclasses.dataclass
class BudgetReport:
    params: ApproxParams
    budget: int
    bound: int                 # analyzer's decision-error bound at params
    logit_bound: int           # bound on the logit nodes themselves
    exact_fa: float
    approx_fa: float
    steps: List[Tuple[str, int]]   # accepted (knob, new value) sequence

    @property
    def area_gain(self) -> float:
        return self.exact_fa / max(self.approx_fa, 1e-9)


def fit_budget(net: ir.Netlist, budget: int, *,
               max_csd_drop: int = 6, max_lsb: int = 10,
               max_argmax_lsb: int = 8
               ) -> Tuple[ApproxParams, ir.Netlist, BudgetReport]:
    """Greedily raise approximation knobs under a worst-case logit-error
    budget (integer logit LSBs, see `logit_budget`). Each round tries a
    one-step raise of every knob (re-running the pipeline from the exact
    netlist — passes compose but error bounds do not decompose, so the
    analyzer must see the whole pipeline); a raise is kept iff the
    decision-error bound stays within budget. Terminates when no knob can
    be raised. Returns (params, approximated netlist, report)."""
    L = net.n_layers
    knobs = ([("csd", i, max_csd_drop) for i in range(L)]
             + [("lsb", i, max_lsb) for i in range(L)]
             + [("argmax", -1, max_argmax_lsb)])
    params = ApproxParams.zero(L)
    exact_fa = COST.structural_cost(net).total_fa
    steps: List[Tuple[str, int]] = []
    best_net: Optional[ir.Netlist] = None

    def bump(p: ApproxParams, kind: str, i: int) -> ApproxParams:
        if kind == "csd":
            v = list(p.csd_drop)
            v[i] += 1
            return dataclasses.replace(p, csd_drop=tuple(v))
        if kind == "lsb":
            v = list(p.lsb)
            v[i] += 1
            return dataclasses.replace(p, lsb=tuple(v))
        return dataclasses.replace(p, argmax_lsb=p.argmax_lsb + 1)

    def level(p: ApproxParams, kind: str, i: int) -> int:
        return (p.csd_drop[i] if kind == "csd"
                else p.lsb[i] if kind == "lsb" else p.argmax_lsb)

    cur_fa = exact_fa
    improved = True
    while improved:
        improved = False
        for kind, i, cap in knobs:
            if level(params, kind, i) >= cap:
                continue
            trial = bump(params, kind, i)
            anet = approximate(net, trial)
            fa = COST.structural_cost(anet).total_fa
            # a bump must actually shrink the circuit: saturated knobs
            # (all CSD digits already dropped, truncation clamped at the
            # word width) rewrite nothing and would otherwise inflate to
            # their caps, overstating the applied approximation
            if fa < cur_fa and decision_error_bound(anet) <= budget:
                params, best_net, improved = trial, anet, True
                cur_fa = fa
                steps.append((f"{kind}[{i}]" if i >= 0 else kind,
                              level(trial, kind, i)))

    if best_net is None:
        best_net = approximate(net, params)
    report = BudgetReport(
        params=params, budget=budget,
        bound=decision_error_bound(best_net),
        logit_bound=logit_error_bound(best_net),
        exact_fa=exact_fa,
        approx_fa=COST.structural_cost(best_net).total_fa,
        steps=steps)
    from repro_torch.verify.diagnostics import verify_enabled
    if verify_enabled():
        # fit_budget's output contract: a verifier-clean, DCE-compacted
        # netlist whose proven decision-error bound honors the budget
        from repro_torch.verify.diagnostics import (ERROR, Diagnostic,
                                                    VerificationError)
        from repro_torch.verify.netlist import check_netlist
        check_netlist(best_net, strict=True, expect_dce=True)
        if report.bound > budget >= 0:
            raise VerificationError([Diagnostic(
                ERROR, "budget",
                f"fit_budget returned bound {report.bound} over the "
                f"requested budget {budget}")])
    return params, best_net, report
