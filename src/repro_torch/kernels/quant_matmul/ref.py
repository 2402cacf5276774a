"""The plain PyTorch version of kernel K2 (`repro.kernels.quant_matmul.ref`)."""
import torch


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) float, w_q (K, N) int8 on a ``bits`` grid, scales (N,) f32
    -> (M, N) in x's dtype, dequantized and accumulated in float32."""
    w = w_q.float() * scales.float()[None, :]
    return (x.float() @ w).to(x.dtype)


def quant_matmul_tolerance(x: torch.Tensor, w_q: torch.Tensor,
                           scales: torch.Tensor,
                           ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.
    Both sum the same K float32 products, in different orders: two orders
    differ by at most 2 K eps32 sum_k |x_k w_kn|. A bf16 output adds one
    rounding on each side, at most 2^-8 of the value each (1% slack for the
    rounding of ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    mag = x.float().abs() @ (w_q.float() * scales.float()[None, :]).abs()
    tol = 2 * x.shape[1] * eps * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
