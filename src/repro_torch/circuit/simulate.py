"""Bit-exact batched netlist simulation in PyTorch.

The netlist is static per compiled model, so all scheduling happens once on
the host, as in `repro.circuit.simulate`: nodes are grouped into
topological levels and, within each level, by opcode. The resulting plan
is a short list of gather -> elementwise-op -> scatter steps over one
``(B, n_nodes)`` value tensor on ``device``. Every intermediate is an exact
machine integer — int32 lanes when the verifier's per-node width bounds say
every datapath word fits a 32-bit lane (`repro_torch.verify.netlist.
fits_int32`; the bound is inclusive at width 32, i.e. exactly the int32
range), int64 otherwise — so the simulation reproduces
`minimize.integer_forward` bit for bit; there is no float anywhere in the
datapath.

The reference's `Simulator` is a plain XLA program, not a Pallas kernel,
so torch integer ops are its port. For *population* throughput (the GA's
netlist-exact objective) use `repro_torch.kernels.netlist_sim`, whose
hand-written kernel `netlist_accuracy` below goes through.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.circuit import ir


@dataclasses.dataclass(frozen=True)
class _Step:
    """One level-batched op group: out[i] = op(a[i] [, b[i] | shift[i]])."""
    op: ir.Op
    out: np.ndarray                   # node ids to write
    a: np.ndarray                     # first-arg node ids
    b: np.ndarray                     # second-arg ids (ADD/SUB) or shifts


@dataclasses.dataclass(frozen=True)
class SimPlan:
    n_nodes: int
    const_ids: np.ndarray
    const_vals: np.ndarray
    input_ids: np.ndarray
    steps: Tuple[_Step, ...]
    pre_ids: Tuple[np.ndarray, ...]   # per-layer integer pre-activations
    output_ids: np.ndarray
    # the ARGMAX node's actual operands: equal to output_ids on exact
    # netlists, but approximation passes may interpose comparator-input
    # TRUNC nodes — the decision must be taken over what the printed
    # comparator tree actually sees
    argmax_ids: np.ndarray
    max_width: int


def build_plan(net: ir.Netlist) -> SimPlan:
    """Schedule the netlist: per topological level, per opcode, one step."""
    steps: List[_Step] = []
    consts: List[Tuple[int, int]] = []
    for level in net.levels():
        by_op: Dict[ir.Op, List[int]] = {}
        for nid in level:
            n = net.nodes[nid]
            if n.op == ir.Op.CONST:
                consts.append((nid, n.value))
            elif n.op in (ir.Op.INPUT, ir.Op.ARGMAX):
                continue              # inputs seeded, argmax done at the end
            else:
                by_op.setdefault(n.op, []).append(nid)
        for op, ids in sorted(by_op.items()):
            nodes = [net.nodes[i] for i in ids]
            a = np.array([n.args[0] for n in nodes], np.int32)
            if op in (ir.Op.SHL, ir.Op.TRUNC):
                b = np.array([n.shift for n in nodes], np.int32)
            elif op in (ir.Op.ADD, ir.Op.SUB):
                b = np.array([n.args[1] for n in nodes], np.int32)
            else:                     # NEG / RELU: unary
                b = np.zeros(len(nodes), np.int32)
            steps.append(_Step(op, np.array(ids, np.int32), a, b))
    cid = np.array([c[0] for c in consts], np.int32)
    cval = np.array([c[1] for c in consts], np.int64)
    am = (net.nodes[net.argmax_id].args if net.argmax_id is not None
          else net.output_ids)
    return SimPlan(
        n_nodes=len(net), const_ids=cid, const_vals=cval,
        input_ids=np.array(net.input_ids, np.int32),
        steps=tuple(steps),
        pre_ids=tuple(np.array(p, np.int32) for p in net.layer_pre_ids),
        output_ids=np.array(net.output_ids, np.int32),
        argmax_ids=np.array(am, np.int32),
        max_width=net.max_width)


class Simulator:
    """Batched evaluator for one netlist on ``device`` (CUDA unless
    ``"cpu"``).

    ``run(x_int)`` -> dict with per-layer integer ``pre`` activations,
    integer ``logits`` and the ``argmax`` class (first maximum on a tie) —
    all exact, as numpy int64. The plan's index and shift tensors are
    staged on the device once and reused across calls.
    """

    def __init__(self, net: ir.Netlist, *, device: DeviceLike = None):
        # lazy: repro_torch.verify imports repro_torch.circuit for the IR
        from repro_torch.verify.netlist import fits_int32
        self.plan = build_plan(net)
        self.device = resolve_device(device)
        self.dtype = torch.int32 if fits_int32(net) else torch.int64

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=self.device)

        self._const_ids = idx(self.plan.const_ids)
        self._const_vals = torch.as_tensor(self.plan.const_vals,
                                           device=self.device).to(self.dtype)
        self._input_ids = idx(self.plan.input_ids)
        self._steps = []
        for s in self.plan.steps:
            b = (idx(s.b) if s.op in (ir.Op.ADD, ir.Op.SUB)
                 else torch.as_tensor(s.b, device=self.device).to(self.dtype))
            self._steps.append((s.op, idx(s.out), idx(s.a), b))
        self._pre_ids = [idx(p) for p in self.plan.pre_ids]
        self._argmax_ids = idx(self.plan.argmax_ids)

    def _evaluate(self, x: torch.Tensor
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x: (B, n_inputs) in the lane type. -> (per-layer pre-activation
        matrices, the argmax comparator's operand matrix)."""
        vals = torch.zeros((x.shape[0], self.plan.n_nodes), dtype=self.dtype,
                           device=self.device)
        vals[:, self._const_ids] = self._const_vals
        vals[:, self._input_ids] = x
        for op, out, a_ids, b in self._steps:
            a = vals[:, a_ids]
            if op == ir.Op.SHL:
                r = torch.bitwise_left_shift(a, b)
            elif op == ir.Op.TRUNC:
                # arithmetic shift right then left: floor-truncate low bits
                r = torch.bitwise_left_shift(torch.bitwise_right_shift(a, b),
                                             b)
            elif op == ir.Op.ADD:
                r = a + vals[:, b]
            elif op == ir.Op.SUB:
                r = a - vals[:, b]
            elif op == ir.Op.NEG:
                r = -a
            else:                     # RELU
                r = torch.clamp_min(a, 0)
            vals[:, out] = r
        return [vals[:, p] for p in self._pre_ids], vals[:, self._argmax_ids]

    def run(self, x_int: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x_int)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        xt = torch.as_tensor(np.asarray(x, np.int64),
                             device=self.device).to(self.dtype)
        pres, amx = self._evaluate(xt)
        # decide over what the comparator tree actually sees (its inputs
        # may be truncated by the approximation passes); torch.argmax
        # returns the first maximum, as the reference's jnp.argmax does
        cls = torch.argmax(amx, dim=-1).cpu().numpy().astype(np.int64)
        pres = [p.cpu().numpy().astype(np.int64) for p in pres]
        if squeeze:
            pres, cls = [p[0] for p in pres], cls[0]
        return {"pre": pres, "logits": pres[-1], "argmax": cls}


def simulate(net: ir.Netlist, x_int: np.ndarray, *,
             device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """One-shot helper (builds a fresh Simulator; reuse Simulator for
    repeated batches)."""
    return Simulator(net, device=device).run(x_int)


def netlist_accuracy(net: ir.Netlist, c, x: np.ndarray, y: np.ndarray, *,
                     device: DeviceLike = None) -> float:
    """Netlist-exact test accuracy: ADC-quantize features with the QAT
    compile's rounding, evaluate the printed datapath on ``device`` (CUDA
    unless ``"cpu"``) through the population engine
    (`repro_torch.kernels.netlist_sim`) with P=1, as the reference does,
    and compare the argmax with ``y``. Bit-exact against `Simulator.run`
    by the kernel's tested contract."""
    from repro_torch.core import minimize as MZ
    from repro_torch.kernels.netlist_sim import (pack_population,
                                                 population_accuracy)
    xq = MZ.quantize_inputs(c, x)
    acc = population_accuracy(pack_population([net]), np.asarray(xq),
                              np.asarray(y), device=device)
    return float(acc[0])
