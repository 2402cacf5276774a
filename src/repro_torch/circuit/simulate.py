"""Netlist-exact accuracy of a compiled bespoke circuit.

Only `netlist_accuracy` is ported so far; it routes through the population
engine (`repro_torch.kernels.netlist_sim`) with P=1, as the reference does.
Every intermediate is an exact machine integer, so the result reproduces
`minimize.integer_forward` bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch import DeviceLike
from repro_torch.circuit import ir


def netlist_accuracy(net: ir.Netlist, c, x: np.ndarray, y: np.ndarray, *,
                     device: DeviceLike = None) -> float:
    """ADC-quantize features with the QAT compile's rounding, evaluate the
    printed datapath on ``device`` (CUDA unless ``"cpu"``), compare the
    argmax with ``y``."""
    from repro_torch.core import minimize as MZ
    from repro_torch.kernels.netlist_sim import (pack_population,
                                                 population_accuracy)
    xq = MZ.quantize_inputs(c, x)
    acc = population_accuracy(pack_population([net]), np.asarray(xq),
                              np.asarray(y), device=device)
    return float(acc[0])
