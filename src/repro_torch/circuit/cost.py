"""Structural area/power/delay from the netlist itself.

`hw_model` prices a design from coefficient statistics (CSD digit counts,
operand counts) without ever building a circuit. This module prices the
*materialized* netlist by counting nodes and edges, using the same
FA-equivalent width conventions — so for every compiled model the two must
agree exactly: multiplier count = product-subnet roots, CSD-digit sum =
mult-tagged SHL wires, adder count = tree + bias ADDs, operand counts =
product edges into each neuron's tree. That agreement (tested per layer in
``tests/test_circuit.py``) turns the analytic cost model from an assumption
into an invariant of the compiler.

What the netlist adds beyond the analytic model is *delay*: the critical
path in adder stages (`ir.Netlist.depths`), which the coefficient
statistics cannot see — it depends on how deep the shift-add chains and
adder trees actually compose.

The pricing is also *approximation-aware* (`repro_torch.approx`): a ``TRUNC``
node is free wiring, and an adder/comparator whose operands provably carry
k zeroed low bits (only an explicit TRUNC chain establishes this — never
structural trailing zeros, so exact netlists price exactly as before)
costs k fewer full-adder equivalents. Truncated-CSD multipliers get
cheaper automatically: fewer digits means fewer mult-tagged SHL wires.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core import hw_model as HW
from repro_torch.circuit import ir

# Printed EGT gate-stage delay. Calibrated so the dense 8-bit bespoke
# classifiers land at the few-Hz operating points reported for printed
# bespoke MLPs (MICRO'20 runs them at single-digit Hz): ~20-30 stages x
# ~5 ms -> ~100 ms/inference. Ripple within an adder is folded into the
# stage constant (same simplification as the area model's FA-equivalents).
DELAY_FA_MS = 5.0


@dataclasses.dataclass
class StructuralLayerCost:
    n_multipliers: int        # product-subnet roots
    csd_digits: int           # mult-tagged SHL wires (one per CSD digit)
    n_adders: int             # tree + bias ADD/SUB gates
    max_operands: int         # widest neuron fan-in (product edges)
    mult_fa: float
    adder_fa: float
    act_fa: float

    @property
    def total_fa(self) -> float:
        return self.mult_fa + self.adder_fa + self.act_fa


@dataclasses.dataclass
class StructuralCost:
    layers: List[StructuralLayerCost]
    argmax_fa: float
    critical_path_levels: int

    @property
    def total_fa(self) -> float:
        return sum(l.total_fa for l in self.layers) + self.argmax_fa

    @property
    def area_mm2(self) -> float:
        return self.total_fa * HW.AREA_FA_MM2

    @property
    def power_mw(self) -> float:
        return self.total_fa * HW.POWER_FA_MW

    @property
    def n_multipliers(self) -> int:
        return sum(l.n_multipliers for l in self.layers)

    @property
    def delay_ms(self) -> float:
        return self.critical_path_levels * DELAY_FA_MS

    @property
    def max_hz(self) -> float:
        return 1e3 / max(self.delay_ms, 1e-9)


def _trunc_levels(net: ir.Netlist) -> List[int]:
    """Guaranteed zeroed low bits per node, established ONLY by explicit
    TRUNC nodes (never by structural trailing zeros — a power-of-two
    product is still priced at full width, preserving exact agreement with
    `hw_model` on unapproximated netlists). TRUNC sets/extends the level;
    ADD/SUB keep the min of their operands (a sum of multiples of 2^k is a
    multiple of 2^k); NEG/RELU preserve it; everything else resets to 0."""
    tz = [0] * len(net.nodes)
    for n in net.nodes:
        if n.op == ir.Op.TRUNC:
            tz[n.id] = max(tz[n.args[0]], n.shift)
        elif n.op in (ir.Op.ADD, ir.Op.SUB):
            tz[n.id] = min(tz[a] for a in n.args)
        elif n.op in (ir.Op.NEG, ir.Op.RELU):
            tz[n.id] = tz[n.args[0]]
    return tz


def structural_cost(net: ir.Netlist) -> StructuralCost:
    """Price the netlist from its structure alone (node/edge counts +
    the analytic model's width conventions). Approximation-aware: TRUNC
    nodes are free, and gates downstream of a TRUNC chain are priced at
    their narrowed width (see `_trunc_levels`)."""
    L = net.n_layers
    n_mult = [0] * L
    csd = [0] * L
    adders = [0] * L
    adder_fa = [0.0] * L
    relus = [0] * L
    # operand count per (layer, neuron): product edges into the tree/bias
    operands: List[Dict[int, int]] = [dict() for _ in range(L)]
    # a tree operand is a product root, possibly seen through TRUNC wiring
    reaches_root = [False] * len(net.nodes)
    for n in net.nodes:
        reaches_root[n.id] = n.product_root or (
            n.op == ir.Op.TRUNC and reaches_root[n.args[0]])
    tz = _trunc_levels(net)

    for n in net.nodes:
        pw = net.in_bits + net.w_bits[n.layer] if 0 <= n.layer < L else 0
        if n.role == ir.ROLE_MULT:
            if n.product_root:
                n_mult[n.layer] += 1
            if n.op == ir.Op.SHL:
                csd[n.layer] += 1
        elif n.role in (ir.ROLE_TREE, ir.ROLE_BIAS):
            if n.op in (ir.Op.ADD, ir.Op.SUB):
                adders[n.layer] += 1
                disc = min(tz[a] for a in n.args)
                adder_fa[n.layer] += float(max(pw - disc, 1))
            k = n.unit[0]
            ops = operands[n.layer]
            ops[k] = ops.get(k, 0) + sum(
                1 for a in n.args if reaches_root[a])
        elif n.role == ir.ROLE_RELU:
            # no width discount here: a ReLU's operand is the bias add,
            # and the hardwired bias constant restores full width (its
            # trunc level is 0 by definition), so truncation upstream in
            # the tree can never narrow the comparator
            relus[n.layer] += 1

    layers = []
    for i in range(L):
        prod_width = net.in_bits + net.w_bits[i]
        max_ops = max(operands[i].values(), default=0)
        acc_w = prod_width + math.ceil(math.log2(max(max_ops, 2)))
        act_fa = relus[i] * HW.RELU_FA_EQ * acc_w
        layers.append(StructuralLayerCost(
            n_multipliers=n_mult[i],
            csd_digits=csd[i],
            n_adders=adders[i],
            max_operands=max_ops,
            mult_fa=float(csd[i] * prod_width) * HW.MULT_ROUTING_FACTOR,
            adder_fa=adder_fa[i],
            act_fa=act_fa))

    am = net.nodes[net.argmax_id] if net.argmax_id is not None else None
    n_logits = len(am.args) if am is not None else 0
    am_w = net.in_bits + net.w_bits[-1] + 4
    if am is not None and am.args:
        am_w = max(am_w - min(tz[a] for a in am.args), 1)
    argmax_fa = max(n_logits - 1, 0) * HW.ARGMAX_FA_EQ * am_w
    return StructuralCost(layers, argmax_fa, net.critical_path_levels())


def cross_validate(net: ir.Netlist, compiled) -> Dict:
    """Compare the structural pricing of ``net`` against `hw_model`'s
    analytic pricing of the same compiled model, layer by layer. Returns a
    report dict with ``ok`` plus every per-layer count pair — used by the
    test suite and the example's circuit summary."""
    sc = structural_cost(net)
    ac = HW.mlp_cost(compiled.q_layers, w_bits=compiled.w_bits,
                     in_bits=compiled.input_bits,
                     clusters=compiled.clusters)
    layers = []
    ok = True
    for s, a in zip(sc.layers, ac.layers):
        row = {
            "n_multipliers": (s.n_multipliers, a.n_multipliers),
            "mult_fa": (s.mult_fa, a.mult_fa),
            "adder_fa": (s.adder_fa, a.adder_fa),
            "act_fa": (s.act_fa, a.act_fa),
        }
        layers.append(row)
        ok &= all(abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1.0)
                  for x, y in row.values())
    ok &= abs(sc.argmax_fa - ac.argmax_fa) <= 1e-9
    ok &= abs(sc.total_fa - ac.total_fa) <= 1e-6 * max(ac.total_fa, 1.0)
    return {"ok": bool(ok), "layers": layers,
            "argmax_fa": (sc.argmax_fa, ac.argmax_fa),
            "total_fa": (sc.total_fa, ac.total_fa),
            "structural": sc, "analytic": ac}


def describe(net: ir.Netlist, sc: StructuralCost = None) -> str:
    """Human-readable compiled-circuit summary (example / bench output)."""
    sc = sc or structural_cost(net)
    ops = net.op_counts()
    lines = [
        f"netlist: {len(net)} nodes "
        f"({', '.join(f'{k}={v}' for k, v in sorted(ops.items()))})",
        f"max wordlength: {net.max_width} bits",
        f"multipliers: {sc.n_multipliers}  "
        f"adders: {sum(l.n_adders for l in sc.layers)}  "
        f"csd digits: {sum(l.csd_digits for l in sc.layers)}",
        f"area: {sc.area_mm2 / 100:.2f} cm^2  power: {sc.power_mw:.2f} mW",
        f"critical path: {sc.critical_path_levels} adder stages "
        f"(~{sc.delay_ms:.0f} ms/inference, ~{sc.max_hz:.1f} Hz)",
    ]
    for i, l in enumerate(sc.layers):
        lines.append(
            f"  layer {i}: mult={l.n_multipliers} csd={l.csd_digits} "
            f"adders={l.n_adders} fan-in<= {l.max_operands} "
            f"fa={l.total_fa:.0f}")
    return "\n".join(lines)
