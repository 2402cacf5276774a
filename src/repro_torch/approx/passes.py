"""The approximation passes (Armeniakos DATE'22; Afentaki ICCAD'23 style):

* :class:`RoundCoeffsCSD` — truncated-CSD coefficient rounding: drop the
  ``drop[layer]`` lowest-significance signed digits of every bespoke
  multiplier coefficient (keeping at least the top digit — the power-of-2
  limit case), rebuilding the shift-add subnet from the kept digits. The
  kept top digits of a canonical recoding are themselves canonical (NAF
  uniqueness), so the rebuilt subnet is exactly the truncated network and
  the cost model's CSD counting stays coherent.
* :class:`TruncateAccum` — adder LSB truncation: wrap every product root
  of a layer in a TRUNC that floors away ``lsb[layer]`` low bits, so the
  whole accumulation tree above it narrows (priced by `circuit.cost`'s
  trunc-level discount).
* :class:`SimplifyActs` — comparator/ReLU simplification: ReLUs whose
  pre-activation interval proves a fixed sign collapse to a wire or a
  hardwired zero (exact — applied only when the operand carries no
  accumulated error, otherwise the clipping could hide an error sign
  flip); argmax comparator inputs are truncated by ``argmax_lsb`` bits,
  narrowing the final comparator tree.

All parameters are per-layer, matching the GA's approximation genes
(`compression_spec.LayerMin.csd_drop` / ``.lsb`` and
``ModelMin.argmax_lsb``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from repro_torch.circuit import compile as CC
from repro_torch.circuit import ir
from repro_torch.core import hw_model as HW
from repro_torch.approx.analyze import propagate_errors
from repro_torch.approx.rewrite import Pass, rebuild


def product_info(net: ir.Netlist, root: int) -> Tuple[int, int]:
    """(source activation id, integer coefficient) of one bespoke
    multiplier subnet, derived purely from the graph: the subnet is the
    mult-role nodes sharing the root's (layer, unit); its unique external
    argument is the source; the coefficient is the subnet evaluated
    symbolically at source = 1."""
    rn = net.nodes[root]
    key = (rn.layer, rn.unit)

    def in_subnet(i: int) -> bool:
        n = net.nodes[i]
        return n.role == ir.ROLE_MULT and (n.layer, n.unit) == key

    src = None
    val: Dict[int, int] = {}

    def ev(i: int) -> int:
        nonlocal src
        if i in val:
            return val[i]
        n = net.nodes[i]
        if not in_subnet(i):
            assert src is None or src == i, \
                f"multiplier subnet at {root} has two sources ({src}, {i})"
            src = i
            v = 1
        elif n.op == ir.Op.SHL:
            v = ev(n.args[0]) << n.shift
        elif n.op == ir.Op.ADD:
            v = ev(n.args[0]) + ev(n.args[1])
        elif n.op == ir.Op.SUB:
            v = ev(n.args[0]) - ev(n.args[1])
        elif n.op == ir.Op.NEG:
            v = -ev(n.args[0])
        elif n.op == ir.Op.TRUNC:        # pre-truncated subnet: treat as wire
            v = ev(n.args[0])
        else:
            raise ValueError(f"unexpected {n.op} inside multiplier subnet")
        val[i] = v
        return v

    coeff = ev(root)
    assert src is not None and coeff != 0, (root, coeff)
    return src, coeff


def truncate_csd(coeff: int, drop: int) -> int:
    """Drop the ``drop`` lowest-significance CSD digits of ``coeff``,
    always keeping the top digit (a zero coefficient would change the
    netlist's *structure*, which is pruning's job, not rounding's)."""
    digits = sorted(HW.csd_digits(coeff))            # ascending shift
    keep = max(len(digits) - max(drop, 0), 1)
    return sum(s << p for p, s in digits[len(digits) - keep:])


class RoundCoeffsCSD(Pass):
    """Truncated-CSD / power-of-2 coefficient rounding, per layer."""

    name = "round-coeffs-csd"
    monotone_cost = True      # dropped digits = fewer SHL wires / gates
    monotone_bound = True     # adds declared local error, removes none

    def __init__(self, drop: Sequence[int]):
        self.drop = [int(d) for d in drop]

    def run(self, net: ir.Netlist) -> ir.Netlist:
        errs = propagate_errors(net)

        def rw(new, old, n, m):
            if not (n.product_root and n.role == ir.ROLE_MULT):
                return None
            drop = self.drop[n.layer] if 0 <= n.layer < len(self.drop) else 0
            if drop <= 0:
                return None
            src, coeff = product_info(old, n.id)
            c2 = truncate_csd(coeff, drop)
            if c2 == coeff:
                return None
            root = CC._lower_const_mult(new, m[src], c2, layer=n.layer,
                                        unit=n.unit)
            # local error: the rebuilt subnet already propagates the
            # source's accumulated error scaled by the NEW coefficient;
            # what it cannot see is (c2 - coeff) * x_exact, with the exact
            # source value bounded by the approx interval minus its error
            d = c2 - coeff
            el, eh = errs[src]
            sn = old.nodes[src]
            xlo, xhi = sn.lo - eh, sn.hi - el
            node = new.nodes[root]
            node.err_lo += min(d * xlo, d * xhi)
            node.err_hi += max(d * xlo, d * xhi)
            return root

        return rebuild(net, rw)


class TruncateAccum(Pass):
    """Adder LSB truncation: floor away ``lsb[layer]`` low bits of every
    product entering the layer's accumulation trees."""

    name = "truncate-accum"
    monotone_cost = True      # TRUNC is free wiring; adders only narrow
    monotone_bound = True     # TRUNC's intrinsic error is a superset

    def __init__(self, lsb: Sequence[int]):
        self.lsb = [int(b) for b in lsb]

    def run(self, net: ir.Netlist) -> ir.Netlist:
        def rw(new, old, n, m):
            if not (n.product_root and n.role == ir.ROLE_MULT):
                return None
            k = self.lsb[n.layer] if 0 <= n.layer < len(self.lsb) else 0
            if k <= 0:
                return None
            from repro_torch.approx.rewrite import copy_node
            root = copy_node(new, n, m)
            k = min(k, max(new.nodes[root].width - 1, 0))
            return new.trunc(root, k, role=ir.ROLE_MULT, layer=n.layer,
                             unit=n.unit)

        return rebuild(net, rw)


class SimplifyActs(Pass):
    """Comparator/ReLU simplification: interval-proven ReLU elision
    (exact) + argmax comparator-input truncation (approximate)."""

    name = "simplify-acts"
    monotone_cost = True      # elision removes gates; trunc narrows
    monotone_bound = True     # exact elision / added comparator error

    def __init__(self, argmax_lsb: int = 0):
        self.argmax_lsb = int(argmax_lsb)

    def run(self, net: ir.Netlist) -> ir.Netlist:
        errs = propagate_errors(net)

        def rw(new, old, n, m):
            if n.op == ir.Op.RELU and errs[n.args[0]] == (0, 0):
                a = old.nodes[n.args[0]]
                if a.lo >= 0:                    # provably non-negative
                    return m[n.args[0]]
                if a.hi <= 0:                    # provably non-positive
                    return new.const(0)
                return None
            if n.op == ir.Op.ARGMAX and self.argmax_lsb > 0:
                logits = []
                for a in n.args:
                    na = m[a]
                    k = min(self.argmax_lsb,
                            max(new.nodes[na].width - 1, 0))
                    logits.append(new.trunc(na, k, role=ir.ROLE_ARGMAX)
                                  if k > 0 else na)
                return new.argmax(logits)
            return None

        return rebuild(net, rw)
