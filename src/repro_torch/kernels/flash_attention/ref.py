"""The plain PyTorch version of kernel K5
(`repro.kernels.flash_attention.ref`)."""
from typing import Optional

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


def flash_attention_tolerance(v: torch.Tensor, ref: torch.Tensor,
                              abs_out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.

    Each output is a convex combination of at most S rows of v, summed in
    float32 in another order (and rescaled tile by tile) by the kernel: at
    most 2 S eps32 max|v| apart, which also covers the few ulp by which the
    two sides' exp and tanh differ. A bf16 output adds one rounding on
    each side, at most 2^-8 of the value each (1% slack for the rounding of
    ``ref`` itself).

    bf16 inputs take a further term. The kernel's tensor-core body rounds
    the probabilities p_s to bf16 before the product with v, and divides by
    l = sum_s p_s summed from the unrounded float32 p. Round to nearest
    gives bf16(p) = p (1 + d_s) with |d_s| <= 2^-8, so the output moves by
    |sum_s p_s d_s v_s| / l <= 2^-8 sum_s (p_s / l) |v_s|: 2^-8 times
    ``abs_out`` = softmax(q k^T / sqrt(d)) |v|, which the plain version
    gives when run in float32 on |v|. The 1% slack covers the bf16 rounding
    of that moved part of the kernel's output (2^-8 of it) and the float32
    error of ``abs_out``. ``abs_out`` is required for bf16 and unused for
    float32, whose body keeps P in float32."""
    eps = torch.finfo(torch.float32).eps
    tol = torch.full(ref.shape, 2 * v.shape[-3] * eps
                     * float(v.float().abs().max()), device=ref.device)
    if ref.dtype == torch.bfloat16:
        if abs_out is None:
            raise ValueError("flash_attention_tolerance needs abs_out, "
                             "softmax(q k^T / sqrt(d)) |v|, for bf16")
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs() \
            + 1.01 * 2.0 ** -8 * abs_out.float()
    return tol
