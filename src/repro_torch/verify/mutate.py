"""Seeded-corruption catalog: known netlist breakages the verifier must
catch, one mutator per invariant class.

Each entry deliberately violates exactly one documented invariant of the
IR (wrong interval, dangling argument, duplicated constant, stale
bookkeeping, ...) while keeping everything else intact — so the tests can
assert not just "a diagnostic fired" but "the *right rule* fired". This is
the acceptance bar of the verification layer: 100% of this catalog
detected, 0 diagnostics on honest compiler/pass outputs.

Mutators operate on a deep copy (`apply_mutation`) and return ``False``
when the netlist lacks the feature they corrupt (e.g. no TRUNC node in an
exact netlist) — the test harness skips those.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, FrozenSet, Optional, Tuple

from repro_torch.circuit import ir


def _first(net: ir.Netlist, pred) -> Optional[ir.Node]:
    return next((n for n in net.nodes if pred(n)), None)


def _wrong_interval(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.args)
    if n is None:
        return False
    n.hi += 1
    return True


def _dangling_arg(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.args)
    if n is None:
        return False
    n.args = (len(net.nodes) + 5,) + n.args[1:]
    return True


def _cycle(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.args)
    if n is None:
        return False
    n.args = (n.id,) + n.args[1:]          # self-reference = 1-cycle
    return True


def _stale_err(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.INPUT)
    if n is None:
        return False
    n.err_lo, n.err_hi = -3, 0             # the ADC is exact by definition
    return True


def _empty_err_interval(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.ADD)
    if n is None:
        return False
    n.err_lo, n.err_hi = 1, -1
    return True


def _bad_arity(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.ADD)
    if n is None:
        return False
    n.args = n.args[:1]
    return True


def _dup_const(net: ir.Netlist) -> bool:
    c = _first(net, lambda n: n.op == ir.Op.CONST)
    if c is None:
        return False
    net.nodes.append(ir.Node(len(net.nodes), ir.Op.CONST, value=c.value,
                             lo=c.value, hi=c.value))
    return True


def _argmax_consumed(net: ir.Netlist) -> bool:
    if net.argmax_id is None:
        return False
    am = net.nodes[net.argmax_id]
    net.nodes.append(ir.Node(len(net.nodes), ir.Op.SHL, (am.id,), shift=0,
                             lo=am.lo, hi=am.hi, role=ir.ROLE_MULT))
    return True


def _stale_argmax_id(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.ADD)
    if n is None or net.argmax_id is None:
        return False
    net.argmax_id = n.id
    return True


def _output_mismatch(net: ir.Netlist) -> bool:
    if len(net.output_ids) < 2:
        return False
    net.output_ids = net.output_ids[:-1]
    return True


def _unregistered_input(net: ir.Netlist) -> bool:
    if not net.input_ids:
        return False
    net.input_ids = net.input_ids[:-1]
    return True


def _negative_shift(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.SHL)
    if n is None:
        return False
    n.shift = -1
    return True


def _identity_trunc(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.TRUNC)
    if n is None:
        return False
    n.shift = 0                            # identity must not be a node
    return True


def _width_bomb(net: ir.Netlist) -> bool:
    c = _first(net, lambda n: n.op == ir.Op.CONST)
    if c is None:
        return False
    v = 1 << 70                            # past the 62-bit sim budget
    c.value, c.lo, c.hi = v, v, v
    return True


def _bad_role(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.RELU)
    if n is None:
        return False
    n.role = ir.ROLE_MULT
    return True


def _trunc_provenance(net: ir.Netlist) -> bool:
    n = _first(net, lambda n: n.op == ir.Op.TRUNC)
    if n is None:
        return False
    n.role = ir.ROLE_TREE                  # not an approximation site
    return True


def _pre_node_swap(net: ir.Netlist) -> bool:
    if len(net.layer_pre_ids) < 2 or not net.layer_pre_ids[0]:
        return False
    p = net.layer_pre_ids[0][0]
    n = net.nodes[p]
    if not n.args:
        return False
    net.layer_pre_ids[0] = [n.args[0]] + net.layer_pre_ids[0][1:]
    return True


def _dead_code(net: ir.Netlist) -> bool:
    if not net.input_ids:
        return False
    src = net.nodes[net.input_ids[0]]
    net.nodes.append(ir.Node(len(net.nodes), ir.Op.NEG, (src.id,),
                             lo=-src.hi, hi=-src.lo, role=ir.ROLE_MULT,
                             layer=0, unit=(0, 0)))
    return True


@dataclasses.dataclass(frozen=True)
class Mutation:
    name: str
    apply: Callable[[ir.Netlist], bool]
    rules: FrozenSet[str]                  # rules allowed to catch it
    strict_only: bool = False              # caught only under strict mode
    needs_dce: bool = False                # caught only under expect_dce


CATALOG: Tuple[Mutation, ...] = (
    Mutation("wrong-interval", _wrong_interval, frozenset({"interval"})),
    Mutation("dangling-arg", _dangling_arg, frozenset({"topo"})),
    Mutation("cycle", _cycle, frozenset({"topo"})),
    Mutation("stale-err", _stale_err, frozenset({"err"})),
    Mutation("empty-err-interval", _empty_err_interval, frozenset({"err"})),
    Mutation("bad-arity", _bad_arity, frozenset({"arity"})),
    Mutation("dup-const", _dup_const,
             frozenset({"const-dedup", "dead-code"})),
    Mutation("argmax-consumed", _argmax_consumed, frozenset({"argmax"})),
    Mutation("stale-argmax-id", _stale_argmax_id, frozenset({"argmax"})),
    Mutation("output-mismatch", _output_mismatch,
             frozenset({"bookkeeping"})),
    Mutation("unregistered-input", _unregistered_input,
             frozenset({"bookkeeping"})),
    Mutation("negative-shift", _negative_shift,
             frozenset({"shift", "interval"})),
    Mutation("identity-trunc", _identity_trunc,
             frozenset({"shift", "interval"})),
    Mutation("width-bomb", _width_bomb, frozenset({"width-budget"})),
    Mutation("bad-role", _bad_role, frozenset({"role"}), strict_only=True),
    Mutation("trunc-provenance", _trunc_provenance,
             frozenset({"trunc-prov", "role"}), strict_only=True),
    Mutation("pre-node-swap", _pre_node_swap, frozenset({"pre-node"}),
             strict_only=True),
    Mutation("dead-code", _dead_code, frozenset({"dead-code"}),
             needs_dce=True),
)


def apply_mutation(net: ir.Netlist, m: Mutation) -> Optional[ir.Netlist]:
    """Deep-copy ``net`` and apply one catalog mutation. Returns the
    corrupted copy, or None when the mutation does not apply."""
    mutant = copy.deepcopy(net)
    return mutant if m.apply(mutant) else None
