"""Quantized matmul (kernel K2): ``y = x @ (w_q * scales[None, :])``, on
int8 payloads or packed 4-bit ones (two values a byte, `pack_int4`), and
its expert body over an MoE layer's stacks, ``y[e] = x[e] @ (w_q[e] *
scales[None, :])`` in one launch (`quant_matmul_experts`)."""
from repro_torch.kernels.quant_matmul.ops import (  # noqa: F401
    quant_matmul, quant_matmul_experts)
from repro_torch.kernels.quant_matmul.ref import (  # noqa: F401
    pack_int4, quant_matmul_experts_ref, quant_matmul_ref,
    quant_matmul_tolerance, unpack_int4)

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_experts",
           "quant_matmul_experts_ref", "quant_matmul_tolerance",
           "pack_int4", "unpack_int4"]
