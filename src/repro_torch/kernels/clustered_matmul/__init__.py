"""Clustered (codebook) matmul (kernel K3): ``y = x @ W`` with
``W[k, n] = codebook[k, idx[k, n]]``, one codebook per input row."""
from repro_torch.kernels.clustered_matmul.ops import clustered_matmul  # noqa: F401,E501
from repro_torch.kernels.clustered_matmul.ref import (  # noqa: F401
    clustered_matmul_ref, clustered_matmul_tolerance)

__all__ = ["clustered_matmul", "clustered_matmul_ref",
           "clustered_matmul_tolerance"]
