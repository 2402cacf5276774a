"""Measured (simulation-based) counterparts of the interval analysis.

`approx.analyze` is deliberately pure-Python-int (a test holds it to
importing neither numpy nor torch — the proofs must not depend on float
semantics). Anything that *simulates* on real inputs lives here instead.
"""
from __future__ import annotations

from repro_torch import DeviceLike
from repro_torch.circuit import ir


def measured_max_logit_error(net: ir.Netlist, compiled, x: "object", *,
                             device: DeviceLike = None) -> int:
    """Measured counterpart of `analyze.logit_error_bound` on real inputs:
    simulate the (approximated) netlist on ``device`` (CUDA unless
    ``"cpu"``) and compare its integer logits against the exact reference
    `minimize.integer_forward`. Soundness demands measured <= predicted on
    every input (tested across all datasets)."""
    import numpy as np

    from repro_torch.circuit.simulate import Simulator
    from repro_torch.core import minimize as MZ

    xq = MZ.quantize_inputs(compiled, x)
    got = Simulator(net, device=device).run(xq)["logits"]
    ref = MZ.integer_forward(compiled, xq)[0][-1]
    return int(np.abs(np.asarray(got, np.int64) - ref).max(initial=0))
