"""NumPy oracle for the population netlist-sim kernel.

Walks every candidate's slot table in order (level-major slots are a
topological order) with exact int64 lanes — the verifier's 62-bit sim
budget guarantees int64 never overflows. Deliberately the dumbest possible
interpretation of the packed tables so kernel bugs can't be mirrored here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.circuit import ir
from repro_torch.kernels.netlist_sim.pack import PackedPopulation


def _normalize_x(pop: PackedPopulation, x: np.ndarray) -> np.ndarray:
    """Accept (B, n_in) shared inputs or (P, B, n_in) per-candidate inputs
    (candidates may quantize the ADC lanes at different input_bits) ->
    (P, B, n_in) int64."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = np.broadcast_to(x[None], (pop.n_candidates,) + x.shape)
    if x.shape[0] != pop.n_candidates or x.shape[2] != pop.n_inputs:
        raise ValueError(f"x shape {x.shape} vs population "
                         f"(P={pop.n_candidates}, n_in={pop.n_inputs})")
    return x.astype(np.int64)


def simulate_population_ref(pop: PackedPopulation, x: np.ndarray
                            ) -> Dict[str, np.ndarray]:
    """-> {"amx": (P, B, C) int64 comparator operands,
           "argmax": (P, B) int64 class decisions}."""
    x = _normalize_x(pop, x)
    P, B = x.shape[0], x.shape[1]
    C = pop.n_classes
    amx = np.zeros((P, B, C), np.int64)
    for p in range(P):
        n = int(pop.n_nodes[p])
        vals = np.zeros((B, n), np.int64)
        vals[:, pop.input_pos[p]] = x[p]
        for s in range(n):
            o = int(pop.op[p, s])
            if o == int(ir.Op.CONST):
                vals[:, s] = pop.val[p, s]
            elif o in (int(ir.Op.INPUT), int(ir.Op.ARGMAX)):
                continue
            else:
                a = vals[:, pop.arg_a[p, s]]
                k = int(pop.shift[p, s])
                if o == int(ir.Op.SHL):
                    vals[:, s] = a << k
                elif o == int(ir.Op.TRUNC):
                    vals[:, s] = (a >> k) << k
                elif o == int(ir.Op.ADD):
                    vals[:, s] = a + vals[:, pop.arg_b[p, s]]
                elif o == int(ir.Op.SUB):
                    vals[:, s] = a - vals[:, pop.arg_b[p, s]]
                elif o == int(ir.Op.NEG):
                    vals[:, s] = -a
                elif o == int(ir.Op.RELU):
                    vals[:, s] = np.maximum(a, 0)
                else:
                    raise ValueError(f"bad opcode {o} at slot {s}")
        amx[p] = vals[:, pop.argmax_pos[p]]
    return {"amx": amx, "argmax": np.argmax(amx, axis=-1).astype(np.int64)}
