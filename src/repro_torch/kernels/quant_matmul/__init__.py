"""Quantized matmul (kernel K2): ``y = x @ (w_q * scales[None, :])``."""
from repro_torch.kernels.quant_matmul.ops import quant_matmul  # noqa: F401
from repro_torch.kernels.quant_matmul.ref import (  # noqa: F401
    quant_matmul_ref, quant_matmul_tolerance)

__all__ = ["quant_matmul", "quant_matmul_ref",
           "quant_matmul_tolerance"]
