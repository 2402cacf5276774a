"""Pass framework over the netlist IR: rebuild walks + the PassManager.

A netlist is immutable-in-spirit (flat topo-ordered ids), so transforms are
expressed as a *rebuild*: walk the old nodes in order, keep an old->new id
map, and let a pass's rewriter intercept any node — returning a replacement
node id built with fresh Netlist constructor calls (intervals and therefore widths are
re-derived by construction), or ``None`` to copy the node verbatim.
Downstream nodes see replacements through the map; orphaned subgraphs are
swept by a final dead-code rebuild. The classifier bookkeeping
(``layer_pre_ids`` / ``output_ids`` / ``argmax_id``) is remapped, so the
simulator and cost model work on transformed netlists unchanged.

Invariants every pass must preserve (DESIGN.md §4c):

* topological order (guaranteed by construction — rewriters only reference
  mapped, already-emitted nodes);
* one bias-add pre node per neuron, ``output_ids == layer_pre_ids[-1]``;
* role/layer/unit tags consistent with the microarchitecture the node
  implements (the cost model prices tags + topology, nothing else);
* any deviation from the exact reference semantics is declared, either
  structurally (TRUNC's intrinsic error) or via the node's local
  ``err_lo/err_hi`` annotation — `approx.analyze` must be able to bound
  the transformed circuit's worst-case logit error.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.circuit import ir

# rewriter(new_net, old_net, node, old_to_new_map) -> new id | None (= copy)
Rewriter = Callable[[ir.Netlist, ir.Netlist, ir.Node, Dict[int, int]],
                    Optional[int]]


def copy_node(new: ir.Netlist, n: ir.Node, m: Dict[int, int]) -> int:
    """Emit a verbatim copy of ``n`` into ``new`` with remapped args.
    Intervals are re-derived by the Netlist constructors; tags, the product-root flag
    and local error annotations are preserved."""
    tags = dict(role=n.role, layer=n.layer, unit=n.unit)
    if n.op == ir.Op.CONST:
        nid = new.const(n.value, **tags)
    elif n.op == ir.Op.INPUT:
        nid = new.input(n.unit[0])
    elif n.op == ir.Op.SHL:
        nid = new.shl(m[n.args[0]], n.shift, **tags)
    elif n.op == ir.Op.TRUNC:
        nid = new.trunc(m[n.args[0]], n.shift, **tags)
    elif n.op == ir.Op.ADD:
        nid = new.add(m[n.args[0]], m[n.args[1]], **tags)
    elif n.op == ir.Op.SUB:
        nid = new.sub(m[n.args[0]], m[n.args[1]], **tags)
    elif n.op == ir.Op.NEG:
        nid = new.neg(m[n.args[0]], **tags)
    elif n.op == ir.Op.RELU:
        nid = new.relu(m[n.args[0]], **tags)
    elif n.op == ir.Op.ARGMAX:
        nid = new.argmax([m[a] for a in n.args])
    else:                                        # pragma: no cover
        raise ValueError(f"unknown op {n.op}")
    node = new.nodes[nid]
    node.product_root = node.product_root or n.product_root
    node.err_lo += n.err_lo
    node.err_hi += n.err_hi
    return nid


def live_set(net: ir.Netlist) -> set:
    """Nodes reachable from the classifier's observation points (argmax,
    logits, every layer's pre-activations) plus every ADC input lane (the
    physical interface exists whether or not a weight survives). Every
    activation node is likewise an observation point: a neuron whose
    outgoing weights are all pruned still prints its accumulator + ReLU
    (the layer-interface convention the analytic ``act_fa`` prices),
    so DCE must not sweep it."""
    live = set()
    stack: List[int] = list(net.input_ids)
    if net.argmax_id is not None:
        stack.append(net.argmax_id)
    for layer in net.layer_pre_ids:
        stack.extend(layer)
    stack.extend(net.output_ids)
    stack.extend(n.id for n in net.nodes if n.op == ir.Op.RELU)
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack.extend(net.nodes[i].args)
    return live


def rebuild(net: ir.Netlist, rewriter: Optional[Rewriter] = None, *,
            dce: bool = False) -> ir.Netlist:
    """One rebuild walk. With ``dce`` dead nodes are skipped (INPUT nodes
    are always kept — they are the ADC interface). The result is validated."""
    new = ir.Netlist(in_bits=net.in_bits, w_bits=list(net.w_bits))
    keep = live_set(net) if dce else None
    m: Dict[int, int] = {}
    for n in net.nodes:
        if keep is not None and n.id not in keep:
            continue
        nid = rewriter(new, net, n, m) if rewriter is not None else None
        if nid is None:
            nid = copy_node(new, n, m)
        m[n.id] = nid
    new.layer_pre_ids = [[m[i] for i in layer] for layer in net.layer_pre_ids]
    new.output_ids = [m[i] for i in net.output_ids]
    new.validate()
    return new


class Pass:
    """One composable netlist transform. Subclasses implement ``run``
    (usually a single `rebuild` with a rewriter) and declare the
    metamorphic invariants the verified pipeline may hold them to."""

    name = "pass"
    # Declared metamorphic invariants, checked by PassManager's verify
    # mode after every application (in the sanctioned pipeline order —
    # `budget.build_passes` runs from an exact netlist):
    monotone_cost = False     # structural cost never increases
    monotone_bound = False    # proven error bounds only widen

    def run(self, net: ir.Netlist) -> ir.Netlist:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__}>"


class PassManager:
    """Applies ordered passes, then one dead-code rebuild that compacts the
    netlist and re-validates it. With an empty pass list the result is
    semantically identical to the input: bit-exact simulation and exactly
    the same structural cost (the compiler's invariants — tested).

    ``verify`` switches the instrumented pipeline on (None defers to the
    ambient ``REPRO_VERIFY`` flag — on under the test suite): the netlist
    verifier runs after *every* pass, and each pass's declared metamorphic
    invariants are differentially checked — cost never increases under the
    truncation passes, the interval-proven error bounds only widen along
    the pipeline, and the final DCE sweep moves neither."""

    def __init__(self, passes: Sequence[Pass] = (), *,
                 verify: Optional[bool] = None):
        self.passes = list(passes)
        self.verify = verify

    def run(self, net: ir.Netlist) -> ir.Netlist:
        from repro_torch.obs import trace as TR
        from repro_torch.verify.diagnostics import verify_enabled
        if not verify_enabled(self.verify):
            if TR.active():
                return self._run_traced(net)
            for p in self.passes:
                net = p.run(net)
            return rebuild(net, dce=True)
        return self._run_verified(net)

    def _run_traced(self, net: ir.Netlist) -> ir.Netlist:
        """The unverified pipeline under tracing: per-pass spans carrying
        the structural-cost and proven-bound deltas each pass bought.
        Deltas are measured on DCE'd snapshots (a rewrite orphans the
        subnets it replaces), which costs one extra rebuild per pass —
        priced only when ``REPRO_TRACE`` is on."""
        from repro_torch.approx.analyze import logit_error_bound
        from repro_torch.circuit.cost import structural_cost
        from repro_torch.obs import metrics as MT
        from repro_torch.obs import trace as TR
        snap = rebuild(net, dce=True)
        cost = structural_cost(snap).total_fa
        bound = logit_error_bound(snap)
        for p in self.passes:
            with TR.span("approx.pass", pass_name=p.name) as sp:
                net = p.run(net)
                snap = rebuild(net, dce=True)
                c2 = structural_cost(snap).total_fa
                b2 = logit_error_bound(snap)
                sp.set(cost_delta=round(c2 - cost, 6),
                       bound_delta=int(b2 - bound))
            MT.counter("approx.passes").inc()
            MT.histogram("approx.pass.cost_delta").observe(c2 - cost)
            cost, bound = c2, b2
        return snap

    def _run_verified(self, net: ir.Netlist) -> ir.Netlist:
        from repro_torch.approx.analyze import (decision_error_bound,
                                                logit_error_bound)
        from repro_torch.circuit.cost import structural_cost
        from repro_torch.verify.diagnostics import (ERROR, Diagnostic,
                                                    VerificationError)
        from repro_torch.verify.netlist import check_netlist

        def fail(rule: str, msg: str):
            raise VerificationError([Diagnostic(ERROR, rule, msg)])

        def measure(n: ir.Netlist):
            """(DCE'd snapshot, its cost, its proven bounds). Differential
            checks must measure the *swept* netlist: a rewrite orphans the
            subnets it replaces, and those stay in the node list (inflating
            structural cost) until the final dead-code rebuild."""
            snap = rebuild(n, dce=True)
            return snap, structural_cost(snap).total_fa, (
                logit_error_bound(snap), decision_error_bound(snap))

        from repro_torch.obs import metrics as MT
        from repro_torch.obs import trace as TR

        # strict conventions are demanded of a pass only when its input
        # already met them (compiler outputs do; hand-built IR need not)
        strict = not check_netlist(net)
        snap, cost, bounds = measure(net)
        for p in self.passes:
            with TR.span("approx.pass", pass_name=p.name) as sp:
                net = p.run(net)
                raw = (logit_error_bound(net), decision_error_bound(net))
                snap, c2, b2 = measure(net)
                sp.set(cost_delta=round(c2 - cost, 6),
                       bound_delta=int(b2[0] - bounds[0]))
            MT.counter("approx.passes").inc()
            MT.histogram("approx.pass.cost_delta").observe(c2 - cost)
            check_netlist(snap, strict=strict, expect_dce=True)
            if raw != b2:
                fail("pass-bound",
                     f"{p.name}: dead-code sweep moved the proven bounds "
                     f"{raw} -> {b2} (DCE must be error-neutral)")
            if p.monotone_cost and c2 > cost + 1e-9:
                fail("pass-cost",
                     f"{p.name}: structural cost increased "
                     f"{cost:.3f} -> {c2:.3f} under a truncation pass")
            if p.monotone_bound and (b2[0] < bounds[0]
                                     or b2[1] < bounds[1]):
                fail("pass-bound",
                     f"{p.name}: proven error bounds narrowed "
                     f"{bounds} -> {b2} — a rewrite lost declared error")
            cost, bounds = c2, b2
        # the last snapshot IS the pipeline result (same final rebuild the
        # unverified path performs)
        return snap
