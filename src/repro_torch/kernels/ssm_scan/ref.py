"""The plain PyTorch version of kernel K6: the model's own selective scan
(`repro.nn.ssm._selective_scan`, which `repro.kernels.ssm_scan.ref` takes
as its oracle), a step-by-step loop over time. It lives here, not in
`nn.ssm`, so that `nn.ssm` can import both it and the kernel's wrapper."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                   C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B, T, d); B_, C_ (B, T, N); A (d, N); D (d,); h0 (B, d, N) or
    None for zeros. Returns y (B, T, d) and h_last (B, d, N), both float32:

        h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = C_t . h_t + D u_t
    """
    Bsz, T, d = u.shape
    N = A.shape[1]
    uf, dtf = u.float(), dt.float()
    bf, cf = B_.float(), C_.float()
    h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(T):
        u_t, dt_t = uf[:, t], dtf[:, t]                   # (B, d)
        da = torch.exp(dt_t[..., None] * A[None])         # (B, d, N)
        h = da * h + (dt_t * u_t)[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + D[None] * u_t)
    y = torch.stack(ys, dim=1) if ys else uf.new_zeros((Bsz, 0, d))
    return y, h


def ssm_scan_ref(u, dt, B_, C_, A, D) -> torch.Tensor:
    """y of `selective_scan` from a zero state, in u's dtype (what kernel K6
    and the TPU kernel write)."""
    y, _ = selective_scan(u, dt, B_, C_, A.float(), D.float())
    return y.to(u.dtype)


def ssm_scan_tolerance(u, dt, B_, C_, A, D, ref: torch.Tensor
                       ) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the same inputs.

    A step of either side rounds a handful of times: dt A, its exp (at most
    2 ulp in CUDA's expf, under 1 on the CPU), da h, dt u, its product with
    B, and the sum; the rounding of dt A moves exp by at most |dt A| eps
    relative, and |dt A| exp(dt A) <= 1/e. So a step adds at most about
    8 eps (|h_{t-1}| + |dt u B|) of error to each state value on each side.
    The recurrence is contractive (exp(dt A) <= 1), so earlier errors decay
    at the state's own rate: with the magnitude recurrence

        H_t = exp(dt_t A) H_{t-1} + |dt_t u_t B_t|
        G_t = H_{t-1} + |dt_t u_t B_t|
        E_t = exp(dt_t A) E_{t-1} + G_t

    (H bounds |h|), the two sides' states differ by at most 16 eps E_t.
    y_t sums N products and adds D u: 2 (N + 2) eps (sum_n |C h| + |D u|)
    for the two sides' sums, plus sum_n |C_n| 16 eps E_t,n carried from
    the state. A bf16 output adds one rounding on each side, at most 2^-8
    of the value each (1% slack for the rounding of ``ref`` itself).

    The card's kernel takes exp(dt A) as 2^(dt (A log2 e)) by
    ex2.approx.ftz.f32: log2 e rounded to float32, A log2 e and its
    product with dt each rounded, so the argument moves by at most
    1.5 eps |dt A| relative (three roundings of eps/2), which moves exp by
    at most 1.5 eps |dt A| exp(dt A) <= 1.5 eps / e < 0.6 eps; the
    instruction is within 2 ulp, at most 2 eps relative (CUDA C++
    Programming Guide: exp2f, and __expf's 2 + floor(|1.173 x|) ulp, which
    is this instruction on x log2 e), and a result below 2^-126 flushes to
    0, an error under 2^-126 |h|, far inside eps |h|. Its step then adds
    at most (2.6 + 0.5) eps |h_{t-1}| (the exp, then one fma for the
    product with h and the sum) and 1.5 eps |dt u B| (dt u, its product
    with B, the sum in that fma): inside the 8 eps (|h_{t-1}| + |dt u B|)
    counted above, so the bound holds unchanged. Its y sums each of 4
    lanes' N/4 products by fma and the lanes' partial sums in a fixed tree,
    which is one order of N + 1 additions among those the 2 (N + 2) eps
    term covers. A CPU emulation of those roundings, with the exp's error pushed
    2 ulp either way and the flush, stays inside the bound
    (tests/test_torch_ssm.py)."""
    eps = torch.finfo(torch.float32).eps
    Bsz, T, d = u.shape
    N = A.shape[1]
    uf, dtf = u.float(), dt.float()
    bf, cf = B_.float().abs(), C_.float().abs()
    Af, Df = A.float(), D.float().abs()
    H = torch.zeros((Bsz, d, N), dtype=torch.float32, device=u.device)
    E = torch.zeros_like(H)
    tols = []
    for t in range(T):
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        inc = (dtf[:, t] * uf[:, t]).abs()[..., None] * bf[:, t, None, :]
        E = da * E + H + inc
        H = da * H + inc
        c = cf[:, t, None, :]
        tols.append(16 * eps * (c * E).sum(-1)
                    + 2 * (N + 2) * eps * ((c * H).sum(-1)
                                           + Df[None] * uf[:, t].abs()))
    tol = torch.stack(tols, dim=1) if tols else uf.new_zeros((Bsz, 0, d))
    if u.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
    return tol
