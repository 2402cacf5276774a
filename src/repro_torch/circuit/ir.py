"""Netlist IR for bespoke printed-MLP circuits.

A :class:`Netlist` is a flat, topologically-ordered list of typed integer
nodes — the dataflow graph of one bespoke classifier as it would be printed:
hardwired constants, ADC inputs, the shift-add networks of every
constant-coefficient multiplier, per-neuron adder trees, bias adds, ReLU
comparators and the final argmax comparator tree.

Every node carries an exact value interval ``[lo, hi]`` propagated from the
inputs (interval arithmetic over the integer ops), from which its minimal
two's-complement ``width`` follows — widths are *derived*, never guessed, so
the simulator can pick a machine dtype that provably cannot overflow and the
cost model can report true per-node wordlengths.

Ops
---
``CONST``   hardwired integer (weights/biases are baked into the layout)
``INPUT``   ADC lane, unsigned ``in_bits`` fixed point
``SHL``     wire shift by a static amount (free: routing, no gates)
``ADD/SUB`` ripple adder/subtractor
``NEG``     two's-complement negate (inverter row + carry-in)
``RELU``    comparator + mux against zero
``ARGMAX``  comparator tree over the class logits -> class index
``TRUNC``   drop the ``shift`` low bits: (a >> k) << k. Free wiring (the low
            wires are simply not connected); downstream adders narrow by k.
            Only the approximation passes (`repro_torch.approx`) emit it.

Approximation bookkeeping: a node may carry a *local* error interval
``[err_lo, err_hi]`` — the worst-case deviation a rewrite pass introduced AT
this node relative to the exact reference circuit (e.g. a rounded
multiplier coefficient). `repro.approx.analyze` propagates these local
intervals (plus TRUNC's intrinsic ``[-(2^k - 1), 0]``) through the graph
into per-logit worst-case bounds. Exact netlists carry ``(0, 0)``
everywhere.

Roles tag each node with its microarchitectural home (``mult`` — inside a
constant multiplier, ``tree`` — adder tree, ``bias`` — bias add, ``relu``,
``argmax``), plus the layer index and the unit (neuron / (row, cluster))
that owns it. ``circuit.cost`` prices the netlist purely from these tags
and the graph structure; ``circuit.simulate`` ignores them.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Sequence, Tuple


class Op(enum.IntEnum):
    CONST = 0
    INPUT = 1
    SHL = 2
    ADD = 3
    SUB = 4
    NEG = 5
    RELU = 6
    ARGMAX = 7
    TRUNC = 8


# roles a node can play in the bespoke microarchitecture
ROLE_CONST = "const"
ROLE_INPUT = "input"
ROLE_MULT = "mult"       # inside a constant-coefficient multiplier subnet
ROLE_TREE = "tree"       # per-neuron adder tree
ROLE_BIAS = "bias"       # per-neuron bias add (accumulator register add)
ROLE_RELU = "relu"
ROLE_ARGMAX = "argmax"


def _twos_complement_bits(lo: int, hi: int) -> int:
    """Minimal two's-complement width holding every integer in [lo, hi]."""
    assert lo <= hi, (lo, hi)
    bits_hi = hi.bit_length() + 1 if hi > 0 else 1       # sign bit included
    bits_lo = (-lo - 1).bit_length() + 1 if lo < 0 else 1
    return max(bits_hi, bits_lo)


@dataclasses.dataclass
class Node:
    """One typed integer node. ``args`` reference earlier node ids only
    (the netlist is constructed in topological order and validated)."""
    id: int
    op: Op
    args: Tuple[int, ...] = ()
    value: int = 0                    # CONST payload
    shift: int = 0                    # SHL amount (static)
    lo: int = 0                       # exact value interval
    hi: int = 0
    role: str = ROLE_CONST
    layer: int = -1                   # owning layer (-1: input / argmax)
    unit: Tuple[int, ...] = ()        # neuron k, or (row j, cluster m)
    product_root: bool = False        # root of one bespoke multiplier subnet
    err_lo: int = 0                   # local approximation error introduced
    err_hi: int = 0                   # at this node (0/0 for exact nodes)

    @property
    def width(self) -> int:
        return _twos_complement_bits(self.lo, self.hi)


class Netlist:
    """Topologically-ordered node list + the classifier-level bookkeeping
    the compiler records: per-layer pre-activation nodes (the bias-add
    outputs — the *integer pre-activations* the QAT reference path defines),
    the logit nodes and the argmax node.

    ``in_bits`` / ``w_bits`` mirror the analytic model's width conventions
    so ``circuit.cost`` can cross-validate ``hw_model`` exactly.
    """

    def __init__(self, *, in_bits: int, w_bits: Sequence[int]):
        self.nodes: List[Node] = []
        self.in_bits = int(in_bits)
        self.w_bits = [int(b) for b in w_bits]
        self.input_ids: List[int] = []
        self.layer_pre_ids: List[List[int]] = []   # bias-add node per neuron
        self.output_ids: List[int] = []            # final-layer logits
        self.argmax_id: Optional[int] = None
        self._const_cache: Dict[int, int] = {}     # value -> node id

    # -- construction -------------------------------------------------------

    def _add(self, node: Node) -> int:
        for a in node.args:
            assert 0 <= a < node.id, (node.id, node.args)
        self.nodes.append(node)
        return node.id

    def const(self, value: int, *, layer: int = -1,
              role: str = ROLE_CONST, unit: Tuple[int, ...] = ()) -> int:
        """Hardwired integer. Deduplicated by value: a printed constant is
        a wire pattern, re-usable everywhere. Because the node is shared,
        caller tags are NOT honored — every CONST carries the canonical
        tags (role=const, layer=-1, unit=()); honoring them would let a
        value-cache hit silently return a node tagged by the *first*
        caller (the verifier enforces canonicality)."""
        del layer, role, unit              # shared node: tags are canonical
        value = int(value)
        if value in self._const_cache:
            return self._const_cache[value]
        nid = self._add(Node(len(self.nodes), Op.CONST, value=value,
                             lo=value, hi=value))
        self._const_cache[value] = nid
        return nid

    def input(self, lane: int) -> int:
        hi = (1 << self.in_bits) - 1
        nid = self._add(Node(len(self.nodes), Op.INPUT, lo=0, hi=hi,
                             role=ROLE_INPUT, unit=(lane,)))
        self.input_ids.append(nid)
        return nid

    def shl(self, a: int, shift: int, **tags) -> int:
        n = self.nodes[a]
        return self._add(Node(len(self.nodes), Op.SHL, (a,), shift=int(shift),
                              lo=n.lo << shift, hi=n.hi << shift, **tags))

    def add(self, a: int, b: int, **tags) -> int:
        na, nb = self.nodes[a], self.nodes[b]
        return self._add(Node(len(self.nodes), Op.ADD, (a, b),
                              lo=na.lo + nb.lo, hi=na.hi + nb.hi, **tags))

    def sub(self, a: int, b: int, **tags) -> int:
        na, nb = self.nodes[a], self.nodes[b]
        return self._add(Node(len(self.nodes), Op.SUB, (a, b),
                              lo=na.lo - nb.hi, hi=na.hi - nb.lo, **tags))

    def neg(self, a: int, **tags) -> int:
        n = self.nodes[a]
        return self._add(Node(len(self.nodes), Op.NEG, (a,),
                              lo=-n.hi, hi=-n.lo, **tags))

    def trunc(self, a: int, shift: int, **tags) -> int:
        """Drop the ``shift`` low bits of ``a``: (a >> shift) << shift with
        arithmetic (floor) semantics. shift == 0 is the identity and emits
        no node. Free wiring — the approximation passes use it to narrow
        downstream adders/comparators."""
        if shift <= 0:
            return a
        n = self.nodes[a]
        return self._add(Node(len(self.nodes), Op.TRUNC, (a,),
                              shift=int(shift),
                              lo=(n.lo >> shift) << shift,
                              hi=(n.hi >> shift) << shift, **tags))

    def relu(self, a: int, **tags) -> int:
        n = self.nodes[a]
        return self._add(Node(len(self.nodes), Op.RELU, (a,),
                              lo=max(n.lo, 0), hi=max(n.hi, 0), **tags))

    def argmax(self, logits: Sequence[int]) -> int:
        logits = tuple(logits)
        if not logits:
            raise ValueError("argmax over an empty logit list")
        if self.argmax_id is not None:
            raise ValueError(
                "argmax already lowered (one comparator tree per netlist)")
        nid = self._add(Node(len(self.nodes), Op.ARGMAX, logits,
                             lo=0, hi=len(logits) - 1, role=ROLE_ARGMAX))
        self.argmax_id = nid
        return nid

    # -- analysis -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_layers(self) -> int:
        return len(self.layer_pre_ids)

    @property
    def max_width(self) -> int:
        return max(n.width for n in self.nodes)

    def depths(self) -> List[int]:
        """Adder-stage depth per node: SHL/TRUNC/CONST/INPUT are wires (+0);
        ADD/SUB/NEG/RELU are one gate stage (+1); ARGMAX is a comparator
        tree, ceil(log2(#logits)) stages. The max over the netlist is the
        critical-path length in full-adder-stage delays."""
        depth = [0] * len(self.nodes)
        for n in self.nodes:
            d = max((depth[a] for a in n.args), default=0)
            if n.op in (Op.ADD, Op.SUB, Op.NEG, Op.RELU):
                d += 1
            elif n.op == Op.ARGMAX:
                d += max(math.ceil(math.log2(max(len(n.args), 2))), 1)
            depth[n.id] = d
        return depth

    def critical_path_levels(self) -> int:
        if not self.nodes:
            return 0
        return max(self.depths())

    def levels(self) -> List[List[int]]:
        """Topological level per node (all args strictly earlier levels) —
        the simulator's batching unit. CONST/INPUT sit at level 0. An
        empty netlist has no levels."""
        if not self.nodes:
            return []
        lev = [0] * len(self.nodes)
        out: List[List[int]] = [[]]
        for n in self.nodes:
            l = 1 + max((lev[a] for a in n.args), default=-1) \
                if n.args else 0
            lev[n.id] = l
            while len(out) <= l:
                out.append([])
            out[l].append(n.id)
        return out

    def op_counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for n in self.nodes:
            c[n.op.name] = c.get(n.op.name, 0) + 1
        return c

    def validate(self) -> None:
        """Structural invariants — delegates to the independent verifier
        (`repro_torch.verify.netlist`): topo order + opcode arity, re-derived
        value intervals, level/depth consistency, CONST dedup, classifier
        bookkeeping, argmax terminality, and the 62-bit simulation budget
        (still raised as the historical OverflowError). Raises
        `repro_torch.verify.VerificationError` (an AssertionError) with the
        full diagnostic list otherwise. Microarchitectural conventions
        (role legality, TRUNC provenance) are reported but non-fatal
        here; the compiler and the pass pipeline check their own outputs
        in strict mode."""
        from repro_torch.verify.netlist import check_netlist
        check_netlist(self)
