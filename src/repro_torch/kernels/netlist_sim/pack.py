"""Dense node-table packing for population-batched netlist simulation.

A compiled netlist (`repro_torch.circuit.ir`) is a flat list of typed integer
nodes. For the population kernel every candidate is re-laid-out into dense
int32 tables over *slots* — node positions in level-major topological order
(levels ascending; ids ascending inside a level, which is deterministic and
dependency-safe because a node's operands always live in strictly earlier
levels):

    op[s]        opcode (ir.Op value; NOP = -1 marks padding slots)
    arg_a[s]     first-operand SLOT index   (0 for CONST/INPUT/ARGMAX)
    arg_b[s]     second-operand SLOT index  (ADD/SUB only, else 0)
    shift[s]     immediate shift amount     (SHL/TRUNC only, else 0)
    val[s]       hardwired payload          (CONST only, else 0; int64)
    orig_id[s]   the source node id — carried so packing is invertible
    level_ptr[l] slot range of level l is [level_ptr[l], level_ptr[l+1])

plus the slot positions of the ADC input lanes (``input_pos``, in
``net.input_ids`` order) and of the argmax comparator's operands
(``argmax_pos`` — the comparator's *actual* inputs, which approximation
passes may truncate). The ARGMAX node itself occupies a slot but is never
executed: the comparator tree is evaluated by the engine's final gather.

A :class:`PackedPopulation` stacks P candidates padded to the population
maxima (slots to ``max n_nodes``, levels to ``max n_levels``): padding
slots carry ``op = NOP`` and ``orig_id = -1``; padded ``level_ptr`` tails
repeat ``n_nodes`` so every level window degenerates to empty. ``max_width``
is the verifier's per-node width bound maximized over the population — the
engines pick int32 lanes iff it is <= 32 (`repro_torch.verify.netlist.fits_int32`
semantics).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from repro_torch.circuit import ir

# Padding-slot opcode sentinel. Real opcodes are ir.Op values 0..8.
NOP = -1

# Opcodes the engines execute (everything except CONST/INPUT seeding and
# the terminal ARGMAX gather).
COMPUTE_OPS = (ir.Op.SHL, ir.Op.ADD, ir.Op.SUB, ir.Op.NEG, ir.Op.RELU,
               ir.Op.TRUNC)


@dataclasses.dataclass(frozen=True)
class PackedNetlist:
    """One candidate's dense node table in level-major slot order."""
    op: np.ndarray          # (n,) int32
    arg_a: np.ndarray       # (n,) int32 slot index
    arg_b: np.ndarray       # (n,) int32 slot index
    shift: np.ndarray       # (n,) int32
    val: np.ndarray         # (n,) int64
    orig_id: np.ndarray     # (n,) int32
    level_ptr: np.ndarray   # (L+1,) int32
    input_pos: np.ndarray   # (n_in,) int32
    argmax_pos: np.ndarray  # (C,) int32
    max_width: int

    @property
    def n_nodes(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_levels(self) -> int:
        return int(self.level_ptr.shape[0]) - 1


@dataclasses.dataclass(frozen=True)
class PackedPopulation:
    """P candidates' tables stacked and padded to the population maxima."""
    op: np.ndarray          # (P, N) int32, NOP on padding slots
    arg_a: np.ndarray       # (P, N) int32
    arg_b: np.ndarray       # (P, N) int32
    shift: np.ndarray       # (P, N) int32
    val: np.ndarray         # (P, N) int64
    orig_id: np.ndarray     # (P, N) int32, -1 on padding slots
    level_ptr: np.ndarray   # (P, L+1) int32
    input_pos: np.ndarray   # (P, n_in) int32
    argmax_pos: np.ndarray  # (P, C) int32
    n_nodes: np.ndarray     # (P,) int32
    n_levels: np.ndarray    # (P,) int32
    max_width: int

    @property
    def n_candidates(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.op.shape[1])

    @property
    def n_inputs(self) -> int:
        return int(self.input_pos.shape[1])

    @property
    def n_classes(self) -> int:
        return int(self.argmax_pos.shape[1])


def pack_netlist(net: ir.Netlist) -> PackedNetlist:
    """Lay one netlist out as dense level-major slot tables."""
    from repro_torch.verify.netlist import max_sim_width
    levels = net.levels()
    order: List[int] = []
    ptr = [0]
    for lev in levels:
        order.extend(sorted(lev))
        ptr.append(len(order))
    n = len(order)
    if n != len(net.nodes):
        raise ValueError(f"levels() covered {n}/{len(net.nodes)} nodes")
    pos = {nid: s for s, nid in enumerate(order)}

    op = np.zeros(n, np.int32)
    arg_a = np.zeros(n, np.int32)
    arg_b = np.zeros(n, np.int32)
    shift = np.zeros(n, np.int32)
    val = np.zeros(n, np.int64)
    orig = np.zeros(n, np.int32)
    for s, nid in enumerate(order):
        nd = net.nodes[nid]
        op[s] = int(nd.op)
        orig[s] = nid
        if nd.op == ir.Op.CONST:
            val[s] = nd.value
        elif nd.op in (ir.Op.SHL, ir.Op.TRUNC):
            arg_a[s] = pos[nd.args[0]]
            shift[s] = nd.shift
        elif nd.op in (ir.Op.ADD, ir.Op.SUB):
            arg_a[s] = pos[nd.args[0]]
            arg_b[s] = pos[nd.args[1]]
        elif nd.op in (ir.Op.NEG, ir.Op.RELU):
            arg_a[s] = pos[nd.args[0]]
        # INPUT seeded below; ARGMAX operands live in argmax_pos

    # the decision is taken over what the comparator tree actually sees
    # (approximation passes may interpose TRUNC nodes) — mirror
    # circuit.simulate.build_plan's convention exactly
    am = (net.nodes[net.argmax_id].args if net.argmax_id is not None
          else net.output_ids)
    return PackedNetlist(
        op=op, arg_a=arg_a, arg_b=arg_b, shift=shift, val=val, orig_id=orig,
        level_ptr=np.array(ptr, np.int32),
        input_pos=np.array([pos[i] for i in net.input_ids], np.int32),
        argmax_pos=np.array([pos[i] for i in am], np.int32),
        max_width=max_sim_width(net))


def pack_population(items: Sequence[Union[ir.Netlist, PackedNetlist]]
                    ) -> PackedPopulation:
    """Stack candidates (netlists or pre-packed tables) padded to the
    population maxima. All candidates must agree on input/class arity —
    one launch simulates one dataset."""
    if not items:
        raise ValueError("empty population")
    packs = [p if isinstance(p, PackedNetlist) else pack_netlist(p)
             for p in items]
    n_in = {p.input_pos.shape[0] for p in packs}
    n_cls = {p.argmax_pos.shape[0] for p in packs}
    if len(n_in) != 1 or len(n_cls) != 1:
        raise ValueError(f"mixed arities in one launch: inputs {sorted(n_in)}"
                         f", classes {sorted(n_cls)}")
    P = len(packs)
    N = max(p.n_nodes for p in packs)
    L = max(p.n_levels for p in packs)

    op = np.full((P, N), NOP, np.int32)
    arg_a = np.zeros((P, N), np.int32)
    arg_b = np.zeros((P, N), np.int32)
    shift = np.zeros((P, N), np.int32)
    val = np.zeros((P, N), np.int64)
    orig = np.full((P, N), -1, np.int32)
    ptr = np.zeros((P, L + 1), np.int32)
    for i, p in enumerate(packs):
        n = p.n_nodes
        op[i, :n] = p.op
        arg_a[i, :n] = p.arg_a
        arg_b[i, :n] = p.arg_b
        shift[i, :n] = p.shift
        val[i, :n] = p.val
        orig[i, :n] = p.orig_id
        ptr[i, :p.n_levels + 1] = p.level_ptr
        ptr[i, p.n_levels + 1:] = n       # trailing levels are empty
    return PackedPopulation(
        op=op, arg_a=arg_a, arg_b=arg_b, shift=shift, val=val, orig_id=orig,
        level_ptr=ptr,
        input_pos=np.stack([p.input_pos for p in packs]),
        argmax_pos=np.stack([p.argmax_pos for p in packs]),
        n_nodes=np.array([p.n_nodes for p in packs], np.int32),
        n_levels=np.array([p.n_levels for p in packs], np.int32),
        max_width=max(p.max_width for p in packs))


def unpack_netlist(pop: PackedPopulation, p: int
                   ) -> Dict[int, Tuple[int, Tuple[int, ...], int, int]]:
    """Invert packing for candidate ``p``:

    -> {orig_node_id: (op, arg orig-ids, shift, const value)}.

    ARGMAX rows report the comparator's operand ids (``argmax_pos`` mapped
    back through ``orig_id``) since packing stores them out of line. Used
    by the round-trip property test — a lossy packer would silently
    simulate a different circuit.
    """
    n = int(pop.n_nodes[p])
    orig = pop.orig_id[p, :n]
    out: Dict[int, Tuple[int, Tuple[int, ...], int, int]] = {}
    for s in range(n):
        o = int(pop.op[p, s])
        if o == int(ir.Op.CONST):
            args: Tuple[int, ...] = ()
        elif o == int(ir.Op.INPUT):
            args = ()
        elif o == int(ir.Op.ARGMAX):
            args = tuple(int(orig[c]) for c in pop.argmax_pos[p])
        elif o in (int(ir.Op.ADD), int(ir.Op.SUB)):
            args = (int(orig[pop.arg_a[p, s]]), int(orig[pop.arg_b[p, s]]))
        else:                              # SHL/NEG/RELU/TRUNC: unary
            args = (int(orig[pop.arg_a[p, s]]),)
        sh = (int(pop.shift[p, s])
              if o in (int(ir.Op.SHL), int(ir.Op.TRUNC)) else 0)
        v = int(pop.val[p, s]) if o == int(ir.Op.CONST) else 0
        out[int(orig[s])] = (o, args, sh, v)
    return out
