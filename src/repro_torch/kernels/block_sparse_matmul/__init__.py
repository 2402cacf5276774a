"""Block-sparse matmul (kernel K4): ``y = x @ (w * expand(block_mask > 0))``,
dead (bk, bn) weight tiles skipped."""
from repro_torch.kernels.block_sparse_matmul.ops import (  # noqa: F401
    block_sparse_matmul)
from repro_torch.kernels.block_sparse_matmul.ref import (  # noqa: F401
    block_sparse_matmul_ref, block_sparse_matmul_tolerance)

__all__ = ["block_sparse_matmul", "block_sparse_matmul_ref",
           "block_sparse_matmul_tolerance"]
