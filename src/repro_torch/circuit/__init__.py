"""Bespoke circuit compiler: netlist IR, bit-exact simulation, structural
cost.

* `repro_torch.circuit.ir`       — typed integer netlist IR with derived
                                   widths
* `repro_torch.circuit.compile`  — QAT compile output -> CSD shift-add
                                   netlist
* `repro_torch.circuit.simulate` — level-batched exact evaluation on torch
                                   integer ops (`Simulator`), and
                                   netlist-exact accuracy through the
                                   population kernel (`netlist_accuracy`)
* `repro_torch.circuit.cost`     — structural area/power (cross-validates
                                   hw_model exactly) + critical-path delay
"""
from repro_torch.circuit import compile, cost, ir, simulate  # noqa: F401
from repro_torch.circuit.compile import compile_netlist, compile_spec  # noqa: F401
from repro_torch.circuit.cost import (DELAY_FA_MS, StructuralCost,  # noqa: F401
                                      cross_validate, describe,
                                      structural_cost)
from repro_torch.circuit.ir import Netlist, Node, Op  # noqa: F401
from repro_torch.circuit.simulate import (Simulator,  # noqa: F401
                                          netlist_accuracy, simulate)
