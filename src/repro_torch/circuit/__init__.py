"""Bespoke circuit compiler: netlist IR, netlist-exact accuracy, structural
cost. ``simulate`` carries only `netlist_accuracy`, routed through the
population engine (`repro_torch.kernels.netlist_sim`)."""
from repro_torch.circuit import compile, cost, ir, simulate  # noqa: F401
from repro_torch.circuit.compile import compile_netlist, compile_spec  # noqa: F401
from repro_torch.circuit.cost import (DELAY_FA_MS, StructuralCost,  # noqa: F401
                                      cross_validate, describe,
                                      structural_cost)
from repro_torch.circuit.ir import Netlist, Node, Op  # noqa: F401
from repro_torch.circuit.simulate import netlist_accuracy  # noqa: F401
