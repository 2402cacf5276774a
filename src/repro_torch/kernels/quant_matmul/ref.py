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

    The plain version sums x_k fl(q_kn s_n) in float32; the kernel sums
    x_k q_kn (exact in float32 for bf16 x, one rounding for float32 x) and
    multiplies the sum by s_n once. With u = eps32 / 2 and
    S = sum_k |x_k w_kn|: the plain version's float32 sum of K terms lies
    within (K - 1) u S of its exact value, in any order; the kernel's within
    (K - 1) 2u S even if the tensor cores truncate where IEEE rounds; fl(q s)
    moves the plain version by at most u S, and the product by s_n and
    float32 x's product rounding move the kernel by at most u S each.
    Together at most 1.5 K eps32 S, inside 2 K eps32 S for every K >= 1.
    A bf16 output adds one rounding on each side, at most 2^-8 of the value
    each (1% slack for the rounding of ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    mag = x.float().abs() @ (w_q.float() * scales.float()[None, :]).abs()
    tol = 2 * x.shape[1] * eps * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
