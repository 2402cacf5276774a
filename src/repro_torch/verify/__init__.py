"""Netlist verifier (copied from `repro.verify`; the spec linter and the
mutation catalog come in a later slice of the port)."""
from repro_torch.verify.diagnostics import (ERROR, WARN, Diagnostic,  # noqa: F401
                                            VerificationError, errors,
                                            verify_enabled)
from repro_torch.verify.netlist import (SIM_WIDTH_BUDGET,  # noqa: F401
                                        check_netlist, fits_int32,
                                        max_sim_width, node_widths,
                                        verify_netlist)
