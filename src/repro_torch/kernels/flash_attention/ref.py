"""The plain PyTorch version of kernel K5
(`repro.kernels.flash_attention.ref`)."""
import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, T, d); k/v: (BH, S, d) -> (BH, T, d) in q's dtype. Scores,
    softmax and the product with v in float32; query t sees key s when
    ``s <= t`` (causal) and ``s > t - window`` (window > 0)."""
    T, S, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * (d ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(T, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(ok[None], p, torch.zeros_like(p))
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def flash_attention_tolerance(v: torch.Tensor,
                              ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.
    Each output is a convex combination of at most S rows of v, summed in
    float32 in another order (and rescaled tile by tile) by the kernel: at
    most 2 S eps32 max|v| apart, which also covers the few ulp by which the
    two sides' exp and tanh differ. A bf16 output adds one rounding on
    each side, at most 2^-8 of the value each (1% slack for the rounding of
    ``ref`` itself)."""
    eps = torch.finfo(torch.float32).eps
    tol = torch.full(ref.shape, 2 * v.shape[-3] * eps
                     * float(v.float().abs().max()), device=ref.device)
    if ref.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
