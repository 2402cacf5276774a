"""Population-batched netlist simulation (see ops.py for the engine map)."""
from repro_torch.kernels.netlist_sim.ops import (netlist_sim,  # noqa: F401
                                                 population_accuracy,
                                                 simulate_levels,
                                                 simulate_population)
from repro_torch.kernels.netlist_sim.pack import (NOP,  # noqa: F401
                                                  PackedNetlist,
                                                  PackedPopulation,
                                                  pack_netlist,
                                                  pack_population,
                                                  unpack_netlist)
from repro_torch.kernels.netlist_sim.ref import \
    simulate_population_ref  # noqa: F401
