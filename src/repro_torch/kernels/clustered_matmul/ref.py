"""The plain PyTorch version of kernel K3
(`repro.kernels.clustered_matmul.ref`)."""
import torch


def _weight(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """W[k, n] = codebook[k, idx[k, n]] in float32, and 0 where idx[k, n]
    lies outside [0, C), as in the Pallas kernel (its one-hot against
    iota(C) matches no entry there)."""
    C = codebook.shape[1]
    i = idx.long()
    inside = (i >= 0) & (i < C)
    w = torch.gather(codebook.float(), 1, i.clamp(0, C - 1))
    return torch.where(inside, w, torch.zeros((), dtype=w.dtype,
                                              device=w.device))


def clustered_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """x (M, K) float, idx (K, N) int, codebook (K, C) float32 -> (M, N) in
    x's dtype: W gathered from the codebooks, the product in float32. An
    index outside [0, C) gives weight 0."""
    return (x.float() @ _weight(idx, codebook)).to(x.dtype)


def clustered_matmul_tolerance(x: torch.Tensor, idx: torch.Tensor,
                               codebook: torch.Tensor,
                               ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.
    Both sum the same K float32 products, in different orders: two orders
    differ by at most 2 K eps32 sum_k |x_k w_kn|. A bf16 output adds one
    rounding on each side, at most 2^-8 of the value each (1% slack for the
    rounding of ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    mag = x.float().abs() @ _weight(idx, codebook).abs()
    tol = 2 * x.shape[1] * eps * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
