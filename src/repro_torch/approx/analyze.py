"""Interval-arithmetic worst-case error analysis of approximated netlists.

For every node of a (possibly transformed) netlist we bound the deviation
``approx_value - exact_value`` of the value it computes from the value the
exact reference circuit (`minimize.integer_forward` semantics) would have
computed at the corresponding point. Sources of error:

* a node's local ``err_lo/err_hi`` annotation — set by rewrite passes for
  deviations the structure cannot show (a rounded multiplier coefficient);
* TRUNC's intrinsic floor-truncation error ``[-(2^k - 1), 0]``.

Propagation rules (exact interval arithmetic over Python ints — no
overflow, no float rounding):

  SHL   e << k                      ADD   ea + eb
  SUB   ea - eb                     NEG   [-eh, -el]
  TRUNC e + [-(2^k - 1), 0]         RELU  [min(el, 0), max(eh, 0)]

The RELU rule holds because relu is 1-Lipschitz and monotone:
relu(x + e) - relu(x) is bounded by e on one side and can collapse to 0 on
the other, never overshooting in either direction. Everything is
worst-case: the bound is sound for *any* input, which is what lets the
budgeted pass search promise a logit-error ceiling without simulating.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.circuit import ir

Interval = Tuple[int, int]


def propagate_errors(net: ir.Netlist) -> List[Interval]:
    """Cumulative worst-case error interval per node (Python-int exact)."""
    out: List[Interval] = []
    for n in net.nodes:
        if n.op in (ir.Op.CONST, ir.Op.INPUT, ir.Op.ARGMAX):
            lo, hi = 0, 0
        elif n.op == ir.Op.SHL:
            al, ah = out[n.args[0]]
            lo, hi = al << n.shift, ah << n.shift
        elif n.op == ir.Op.TRUNC:
            al, ah = out[n.args[0]]
            lo, hi = al - ((1 << n.shift) - 1), ah
        elif n.op == ir.Op.ADD:
            (al, ah), (bl, bh) = out[n.args[0]], out[n.args[1]]
            lo, hi = al + bl, ah + bh
        elif n.op == ir.Op.SUB:
            (al, ah), (bl, bh) = out[n.args[0]], out[n.args[1]]
            lo, hi = al - bh, ah - bl
        elif n.op == ir.Op.NEG:
            al, ah = out[n.args[0]]
            lo, hi = -ah, -al
        elif n.op == ir.Op.RELU:
            al, ah = out[n.args[0]]
            lo, hi = min(al, 0), max(ah, 0)
        else:                                    # pragma: no cover
            raise ValueError(f"unknown op {n.op}")
        out.append((lo + n.err_lo, hi + n.err_hi))
    return out


def _max_abs(errs: List[Interval], ids) -> int:
    return max((max(abs(errs[i][0]), abs(errs[i][1])) for i in ids),
               default=0)


def logit_error_bound(net: ir.Netlist) -> int:
    """Worst-case |approx - exact| over the integer logits (the last
    layer's pre-activation nodes), in logit LSBs."""
    return _max_abs(propagate_errors(net), net.output_ids)


def decision_error_bound(net: ir.Netlist) -> int:
    """Worst-case error at the argmax comparator inputs — includes any
    comparator-input truncation the logit nodes themselves don't see. An
    argmax decision can only flip when two exact logits are closer than
    twice this bound."""
    errs = propagate_errors(net)
    if net.argmax_id is None:
        return _max_abs(errs, net.output_ids)
    return _max_abs(errs, net.nodes[net.argmax_id].args)
