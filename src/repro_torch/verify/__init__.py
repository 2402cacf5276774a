"""Static-analysis layer, copied from `repro.verify`: machine-checked
invariants for the circuit compiler, the approximation passes and the
search stack.

* `repro_torch.verify.netlist` — re-derives every node's interval/width,
  the topo/level/depth analyses and the classifier bookkeeping
  independently of the IR's own code and reports structured `Diagnostic`
  records (`Netlist.validate()` delegates here; the pass pipeline and the
  compiler check their outputs in strict mode).
* `repro_torch.verify.spec` — lints `ModelMin` genomes before any costly
  QAT evaluation: gene-range/arch legality plus serialize->parse->
  serialize byte-stability (the EvalCache keyspace guard).
* `repro_torch.verify.mutate` — the seeded-corruption catalog the tests
  use to prove the verifier catches each invariant class.

The ambient switch is the ``REPRO_VERIFY`` env var (`verify_enabled`):
the test suite turns it on, so every pass, every compile and every
population evaluation under test is verified; production sweeps leave it
off and pay nothing.
"""
from repro_torch.verify.diagnostics import (ERROR, WARN, Diagnostic,  # noqa: F401
                                            VerificationError, errors,
                                            verify_enabled)
from repro_torch.verify.netlist import (SIM_WIDTH_BUDGET,  # noqa: F401
                                        check_netlist, fits_int32,
                                        max_sim_width, node_widths,
                                        verify_netlist)
from repro_torch.verify.spec import (check_specs, lint_spec,  # noqa: F401
                                     lint_specs)
from repro_torch.verify.mutate import (CATALOG, Mutation,  # noqa: F401
                                       apply_mutation)
