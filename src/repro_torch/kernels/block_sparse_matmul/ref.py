"""The plain PyTorch version of kernel K4
(`repro.kernels.block_sparse_matmul.ref`)."""
import torch


def live_weight(w: torch.Tensor, block_mask: torch.Tensor, *, block_k: int,
                block_n: int) -> torch.Tensor:
    """w with every dead tile zeroed, in w's dtype. A tile is live where
    its mask entry is > 0, as in the Pallas kernel."""
    kt, nt = block_mask.shape
    live = (block_mask > 0)[:, None, :, None].expand(kt, block_k, nt, block_n)
    return w * live.reshape(w.shape).to(w.dtype)


def block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                            block_mask: torch.Tensor, *, block_k: int,
                            block_n: int) -> torch.Tensor:
    """x (M, K), w (K, N), block_mask (K/bk, N/bn) -> (M, N) in x's dtype,
    the product of the live tiles in float32."""
    wl = live_weight(w, block_mask, block_k=block_k, block_n=block_n)
    return (x.float() @ wl.float()).to(x.dtype)


def block_sparse_matmul_tolerance(x: torch.Tensor, w: torch.Tensor,
                                  block_mask: torch.Tensor,
                                  ref: torch.Tensor, *, block_k: int,
                                  block_n: int) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.
    Both sum the same K float32 products (zero for a dead tile), in
    different orders: two orders differ by at most 2 K eps32
    sum_k |x_k w_kn|. A bf16 output adds one rounding on each side, at most
    2^-8 of the value each (1% slack for the rounding of ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    wl = live_weight(w, block_mask, block_k=block_k, block_n=block_n)
    tol = 2 * x.shape[1] * eps * (x.float().abs() @ wl.float().abs())
    if x.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
