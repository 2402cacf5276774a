"""Netlist verifier: machine-checked invariants of the circuit IR.

Everything the compiler (`circuit.compile`), the rebuild machinery
(`approx.rewrite`) and the cost/simulation consumers rely on is re-derived
here *independently* — the verifier never calls the methods it is checking
(`levels()`, `depths()`, the builder interval rules), it re-implements
their documented semantics and compares. A bug in either side surfaces as
a diagnostic instead of a silently wrong Pareto point.

Rule catalog (DESIGN.md §5):

ERROR (structural soundness — fatal under any checking mode)
  node-index    ``nodes[i].id == i`` (flat topo list is positional)
  arity         per-opcode argument count (ARGMAX: >= 1 logits)
  topo          every arg references a strictly earlier node
  shift         SHL shift >= 0; TRUNC shift >= 1 (0 is the identity and
                must not materialize a node)
  interval      ``lo <= hi`` and the stored interval equals the opcode's
                interval semantics re-derived from the operand intervals
  err           ``err_lo <= err_hi``; CONST/INPUT/ARGMAX carry no local
                error (a deduplicated constant would leak its annotation
                into every user; the ADC and the decision node are exact)
  levels        `Netlist.levels()` matches an independent re-derivation
                (partition of all ids, level = 1 + max over args)
  depths        `critical_path_levels()` matches the documented delay
                semantics (wires +0, gates +1, ARGMAX ceil(log2 n))
  const-dedup   no two CONST nodes share a value (the builder's cache
                invariant — shared constants are one wire pattern)
  bookkeeping   pre/output/input/argmax ids in range and of the right op;
                ``output_ids == layer_pre_ids[-1]``; one ``w_bits`` entry
                per lowered layer; every INPUT registered
  argmax        at most one ARGMAX node, ``argmax_id`` points at it, and
                it is terminal (nothing consumes the class index)
  width-budget  max derived width <= 62 bits (the exact int64 simulation
                budget; `Netlist.validate` maps this rule to the
                historical OverflowError)

WARN (microarchitectural conventions — fatal only under ``strict=True``,
      which is how compiler/pass outputs are checked; hand-built test
      netlists remain legal under the default mode)
  role          op/role legality (SHL only inside multiplier subnets,
                ADD only as mult/tree/bias, RELU tagged relu, ...);
                layer index within the lowered range; CONST tags canonical
  trunc-prov    TRUNC only at the approximation sites (product roots /
                argmax comparator inputs) — exact lowering never emits it
  pre-node      every ``layer_pre_ids[i][k]`` is the neuron's bias ADD
                (role bias, layer i, unit (k,))
  argmax-feed   argmax operands are the logits, possibly through an
                explicit TRUNC chain (comparator-input truncation)

Opt-in modes
  expect_exact  the netlist claims to be exact: any TRUNC node or nonzero
                err annotation is an ERROR (rule ``exact``)
  expect_dce    the netlist claims to be DCE-clean: every node must be
                reachable from the observation points (rule ``dead-code``)
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.circuit import ir
from repro_torch.verify.diagnostics import (ERROR, WARN, Diagnostic,
                                      VerificationError, errors)

SIM_WIDTH_BUDGET = 62

_ARITY = {
    ir.Op.CONST: 0, ir.Op.INPUT: 0, ir.Op.SHL: 1, ir.Op.ADD: 2,
    ir.Op.SUB: 2, ir.Op.NEG: 1, ir.Op.RELU: 1, ir.Op.TRUNC: 1,
}

# op -> legal roles in anything the compiler or the sanctioned passes emit
_OP_ROLES = {
    ir.Op.CONST: {ir.ROLE_CONST},
    ir.Op.INPUT: {ir.ROLE_INPUT},
    ir.Op.SHL: {ir.ROLE_MULT},
    ir.Op.ADD: {ir.ROLE_MULT, ir.ROLE_TREE, ir.ROLE_BIAS},
    ir.Op.SUB: {ir.ROLE_MULT},
    ir.Op.NEG: {ir.ROLE_MULT},
    ir.Op.RELU: {ir.ROLE_RELU},
    ir.Op.TRUNC: {ir.ROLE_MULT, ir.ROLE_ARGMAX},
    ir.Op.ARGMAX: {ir.ROLE_ARGMAX},
}


def _prov(n: ir.Node) -> str:
    return (f"op={n.op.name} role={n.role} layer={n.layer} "
            f"unit={n.unit}")


def _bits(lo: int, hi: int) -> int:
    """Independent re-derivation of the minimal two's-complement width."""
    bits_hi = hi.bit_length() + 1 if hi > 0 else 1
    bits_lo = (-lo - 1).bit_length() + 1 if lo < 0 else 1
    return max(bits_hi, bits_lo)


def node_widths(net: ir.Netlist) -> List[int]:
    """Per-node minimal two's-complement widths of the datapath words,
    re-derived from the stored intervals (the ARGMAX comparator emits a
    class index, not a datapath word, so it is excluded — same population
    as the 62-bit sim-budget check below)."""
    return [_bits(n.lo, n.hi) for n in net.nodes if n.op != ir.Op.ARGMAX]


def max_sim_width(net: ir.Netlist) -> int:
    """Widest datapath word a simulator lane must hold for this net."""
    ws = node_widths(net)
    return max(ws) if ws else 1


def fits_int32(net: ir.Netlist) -> bool:
    """True when every datapath word fits an int32 lane. The bound is per
    node and inclusive at 32: a width-32 two's-complement interval is
    exactly [-2^31, 2^31 - 1], i.e. the int32 range — simulators used to
    promote such nets to int64 off a ``> 31`` whole-net check and pay for
    64-bit lanes they never needed."""
    return max_sim_width(net) <= 32


def _expected_interval(net: ir.Netlist, n: ir.Node):
    """Re-derive a node's value interval from its operands' stored
    intervals per the documented opcode semantics. Returns None when the
    semantics do not constrain it from here (unknown op)."""
    a = net.nodes[n.args[0]] if n.args else None
    if n.op == ir.Op.CONST:
        return n.value, n.value
    if n.op == ir.Op.INPUT:
        return 0, (1 << net.in_bits) - 1
    if n.op in (ir.Op.SHL, ir.Op.TRUNC) and n.shift < 0:
        return None                    # the shift rule already fired
    if n.op == ir.Op.SHL:
        return a.lo << n.shift, a.hi << n.shift
    if n.op == ir.Op.TRUNC:
        return (a.lo >> n.shift) << n.shift, (a.hi >> n.shift) << n.shift
    if n.op == ir.Op.ADD:
        b = net.nodes[n.args[1]]
        return a.lo + b.lo, a.hi + b.hi
    if n.op == ir.Op.SUB:
        b = net.nodes[n.args[1]]
        return a.lo - b.hi, a.hi - b.lo
    if n.op == ir.Op.NEG:
        return -a.hi, -a.lo
    if n.op == ir.Op.RELU:
        return max(a.lo, 0), max(a.hi, 0)
    if n.op == ir.Op.ARGMAX:
        return 0, len(n.args) - 1
    return None


def verify_netlist(net: ir.Netlist, *, expect_exact: bool = False,
                   expect_dce: bool = False) -> List[Diagnostic]:
    """Run every rule; return all findings (ERROR and WARN severity)."""
    out: List[Diagnostic] = []
    N = len(net.nodes)

    def diag(sev, rule, msg, n: Optional[ir.Node] = None):
        out.append(Diagnostic(sev, rule, msg,
                              node=None if n is None else n.id,
                              provenance="" if n is None else _prov(n)))

    # ---- per-node structural rules ---------------------------------------
    sane_args = [False] * N            # args valid -> later rules may deref
    for i, n in enumerate(net.nodes):
        if n.id != i:
            diag(ERROR, "node-index", f"node at position {i} has id {n.id}",
                 n)
            continue
        want = _ARITY.get(n.op)
        if n.op == ir.Op.ARGMAX:
            if len(n.args) < 1:
                diag(ERROR, "arity", "ARGMAX over an empty logit list", n)
                continue
        elif want is None:
            diag(ERROR, "arity", f"unknown opcode {n.op!r}", n)
            continue
        elif len(n.args) != want:
            diag(ERROR, "arity",
                 f"{n.op.name} takes {want} arg(s), has {len(n.args)}", n)
            continue
        bad = [a for a in n.args if not (0 <= a < n.id)]
        if bad:
            diag(ERROR, "topo",
                 f"arg(s) {bad} not strictly earlier than node {n.id} "
                 "(dangling reference or cycle)", n)
            continue
        sane_args[i] = True

    for i, n in enumerate(net.nodes):
        if not sane_args[i]:
            continue
        if n.op == ir.Op.SHL and n.shift < 0:
            diag(ERROR, "shift", f"negative SHL shift {n.shift}", n)
        if n.op == ir.Op.TRUNC and n.shift < 1:
            diag(ERROR, "shift",
                 f"TRUNC shift {n.shift} (0 is the identity and must not "
                 "materialize a node)", n)
        if n.lo > n.hi:
            diag(ERROR, "interval", f"empty interval [{n.lo}, {n.hi}]", n)
        elif all(sane_args[a] for a in n.args):
            exp = _expected_interval(net, n)
            if exp is not None and exp != (n.lo, n.hi):
                diag(ERROR, "interval",
                     f"stored interval [{n.lo}, {n.hi}] != re-derived "
                     f"[{exp[0]}, {exp[1]}]", n)
        if n.err_lo > n.err_hi:
            diag(ERROR, "err",
                 f"empty error interval [{n.err_lo}, {n.err_hi}]", n)
        if (n.op in (ir.Op.CONST, ir.Op.INPUT, ir.Op.ARGMAX)
                and (n.err_lo, n.err_hi) != (0, 0)):
            diag(ERROR, "err",
                 f"{n.op.name} carries a local error annotation "
                 f"[{n.err_lo}, {n.err_hi}] (deduplicated constants would "
                 "leak it; ADC/decision nodes are exact by definition)", n)

    structurally_sound = all(sane_args) and not errors(out)

    # ---- derived-analysis consistency (only meaningful on sound graphs) --
    if structurally_sound and N:
        lev = [0] * N
        depth = [0] * N
        for n in net.nodes:
            lev[n.id] = 1 + max((lev[a] for a in n.args), default=-1) \
                if n.args else 0
            d = max((depth[a] for a in n.args), default=0)
            if n.op in (ir.Op.ADD, ir.Op.SUB, ir.Op.NEG, ir.Op.RELU):
                d += 1
            elif n.op == ir.Op.ARGMAX:
                d += max(math.ceil(math.log2(max(len(n.args), 2))), 1)
            depth[n.id] = d
        got = net.levels()
        want_levels: List[List[int]] = [[] for _ in range(max(lev) + 1)]
        for i, l in enumerate(lev):
            want_levels[l].append(i)
        if [sorted(g) for g in got] != want_levels:
            diag(ERROR, "levels",
                 "Netlist.levels() disagrees with the re-derived "
                 "topological levels")
        if net.critical_path_levels() != max(depth):
            diag(ERROR, "depths",
                 f"critical_path_levels() = {net.critical_path_levels()} "
                 f"but re-derived delay semantics give {max(depth)}")

        seen_const = {}
        for n in net.nodes:
            if n.op == ir.Op.CONST:
                if n.value in seen_const:
                    diag(ERROR, "const-dedup",
                         f"CONST value {n.value} duplicated at nodes "
                         f"{seen_const[n.value]} and {n.id}", n)
                else:
                    seen_const[n.value] = n.id

    # width budget reads only each node's *stored* interval, so it runs
    # even on graphs with other structural findings (an overflowing node
    # must surface as such, not hide behind a stale consumer interval)
    widths = [_bits(n.lo, n.hi) for n in net.nodes
              if isinstance(n.lo, int) and isinstance(n.hi, int)
              and n.lo <= n.hi]
    if widths and max(widths) > SIM_WIDTH_BUDGET:
        diag(ERROR, "width-budget",
             f"netlist width {max(widths)} exceeds the {SIM_WIDTH_BUDGET}"
             "-bit exact simulation budget (degenerate scale chain?)")

    # ---- classifier bookkeeping ------------------------------------------
    def in_range(i) -> bool:
        return isinstance(i, int) and 0 <= i < N

    if not net.layer_pre_ids:
        diag(ERROR, "bookkeeping", "no layers lowered (layer_pre_ids empty)")
    if len(net.w_bits) != len(net.layer_pre_ids):
        diag(ERROR, "bookkeeping",
             f"{len(net.w_bits)} w_bits entries for "
             f"{len(net.layer_pre_ids)} lowered layers")
    flat_ok = True
    for li, layer in enumerate(net.layer_pre_ids):
        for p in layer:
            if not in_range(p):
                diag(ERROR, "bookkeeping",
                     f"layer_pre_ids[{li}] references node {p} "
                     f"outside [0, {N})")
                flat_ok = False
    if net.layer_pre_ids and net.output_ids != net.layer_pre_ids[-1]:
        diag(ERROR, "bookkeeping",
             "output_ids != layer_pre_ids[-1] (the logits are the last "
             "layer's pre-activations)")
    for i in net.output_ids:
        if not in_range(i):
            diag(ERROR, "bookkeeping",
                 f"output_ids references node {i} outside [0, {N})")
            flat_ok = False
    input_nodes = [n.id for n in net.nodes if n.op == ir.Op.INPUT]
    if structurally_sound and sorted(net.input_ids) != input_nodes:
        diag(ERROR, "bookkeeping",
             f"input_ids {net.input_ids} does not cover the INPUT nodes "
             f"{input_nodes} exactly")

    # ---- argmax terminality / uniqueness ---------------------------------
    if structurally_sound:
        am_nodes = [n.id for n in net.nodes if n.op == ir.Op.ARGMAX]
        if len(am_nodes) > 1:
            diag(ERROR, "argmax", f"multiple ARGMAX nodes {am_nodes}")
        if net.argmax_id is not None:
            if not in_range(net.argmax_id):
                diag(ERROR, "argmax",
                     f"argmax_id {net.argmax_id} outside [0, {N})")
            elif net.nodes[net.argmax_id].op != ir.Op.ARGMAX:
                diag(ERROR, "argmax",
                     f"argmax_id {net.argmax_id} is a "
                     f"{net.nodes[net.argmax_id].op.name} node, not ARGMAX",
                     net.nodes[net.argmax_id])
        elif am_nodes:
            diag(ERROR, "argmax",
                 f"ARGMAX node {am_nodes[0]} exists but argmax_id is None")
        for n in net.nodes:
            users = [a for a in n.args
                     if a < N and net.nodes[a].op == ir.Op.ARGMAX]
            if users:
                diag(ERROR, "argmax",
                     f"node {n.id} consumes ARGMAX output {users} — the "
                     "class index is terminal", n)

    # ---- convention (WARN) rules -----------------------------------------
    if structurally_sound and flat_ok:
        L = len(net.layer_pre_ids)
        for n in net.nodes:
            legal = _OP_ROLES.get(n.op, set())
            if n.role not in legal:
                diag(WARN, "role",
                     f"role {n.role!r} illegal for {n.op.name} "
                     f"(expected one of {sorted(legal)})", n)
            if not (-1 <= n.layer <= max(L - 1, -1)):
                diag(WARN, "role",
                     f"layer {n.layer} outside the lowered range "
                     f"[-1, {L - 1}]", n)
            if n.op == ir.Op.CONST and (n.role, n.layer, n.unit) != (
                    ir.ROLE_CONST, -1, ()):
                diag(WARN, "role",
                     "shared CONST must carry the canonical tags "
                     "(role=const, layer=-1, unit=()) — it is one wire "
                     "pattern owned by no layer", n)
            if n.op == ir.Op.TRUNC and n.role not in (ir.ROLE_MULT,
                                                      ir.ROLE_ARGMAX):
                diag(WARN, "trunc-prov",
                     "TRUNC outside the approximation sites (product "
                     "roots / argmax comparator inputs)", n)
        for li, layer in enumerate(net.layer_pre_ids):
            for k, p in enumerate(layer):
                pn = net.nodes[p]
                if (pn.op != ir.Op.ADD or pn.role != ir.ROLE_BIAS
                        or pn.layer != li or pn.unit != (k,)):
                    diag(WARN, "pre-node",
                         f"layer_pre_ids[{li}][{k}] is not that neuron's "
                         "bias ADD (op=ADD role=bias layer=i unit=(k,))",
                         pn)
        if net.argmax_id is not None and in_range(net.argmax_id):
            outs = set(net.output_ids)
            for a in net.nodes[net.argmax_id].args:
                root = a
                while (net.nodes[root].op == ir.Op.TRUNC
                       and net.nodes[root].args):
                    root = net.nodes[root].args[0]
                if root not in outs:
                    diag(WARN, "argmax-feed",
                         f"argmax operand {a} is not a logit (or a TRUNC "
                         "chain over one)", net.nodes[a])

    # ---- opt-in modes ----------------------------------------------------
    if expect_exact and structurally_sound:
        for n in net.nodes:
            if n.op == ir.Op.TRUNC:
                diag(ERROR, "exact",
                     "TRUNC in a netlist claimed exact (only the "
                     "approximation passes emit it)", n)
            if (n.err_lo, n.err_hi) != (0, 0):
                diag(ERROR, "exact",
                     f"error annotation [{n.err_lo}, {n.err_hi}] in a "
                     "netlist claimed exact", n)

    if expect_dce and structurally_sound and flat_ok:
        # independent live-set walk (same observation points as the DCE:
        # argmax, logits, every layer's pre nodes, every ADC input lane,
        # and every activation node — a fully-fanout-pruned neuron still
        # prints its ReLU, per the PR 3 layer-interface convention)
        live = set()
        stack = list(net.input_ids) + list(net.output_ids)
        if net.argmax_id is not None:
            stack.append(net.argmax_id)
        for layer in net.layer_pre_ids:
            stack.extend(layer)
        stack.extend(n.id for n in net.nodes if n.op == ir.Op.RELU)
        while stack:
            i = stack.pop()
            if i in live or not in_range(i):
                continue
            live.add(i)
            stack.extend(net.nodes[i].args)
        dead = [n.id for n in net.nodes if n.id not in live]
        if dead:
            diag(ERROR, "dead-code",
                 f"{len(dead)} unreachable node(s) in a netlist claimed "
                 f"DCE-clean (first few: {dead[:8]})")

    return out


def check_netlist(net: ir.Netlist, *, strict: bool = False,
                  expect_exact: bool = False,
                  expect_dce: bool = False) -> List[Diagnostic]:
    """Verify and raise on fatal findings. Non-strict raises only on
    ERROR-severity (structural) findings; ``strict=True`` — the mode the
    compiler and pass pipeline use on their own outputs — also promotes
    the convention (WARN) rules to fatal. Returns all diagnostics when
    nothing is fatal. The historical `OverflowError` contract of
    `Netlist.validate` is preserved for the width-budget rule."""
    diags = verify_netlist(net, expect_exact=expect_exact,
                           expect_dce=expect_dce)
    fatal = diags if strict else errors(diags)
    if fatal:
        if all(d.rule == "width-budget" for d in fatal):
            raise OverflowError(fatal[0].message)
        raise VerificationError(fatal)
    return diags
