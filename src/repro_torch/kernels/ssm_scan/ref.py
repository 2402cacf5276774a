"""The plain PyTorch version of kernel K6: the model's own selective scan
(`repro.nn.ssm._selective_scan`, which `repro.kernels.ssm_scan.ref` takes
as its oracle), a step-by-step loop over time. It lives here, not in
`nn.ssm`, so that `nn.ssm` can import both it and the kernel's wrapper."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _work(a: torch.Tensor) -> torch.Tensor:
    """``a`` in the type the plain versions compute in: float32, or float64
    for float64 inputs (the tests' exact reference)."""
    return a if a.dtype == torch.float64 else a.float()


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
    uf, dtf, bf, cf = (_work(a) for a in (u, dt, B_, C_))
    h = torch.zeros((Bsz, d, N), dtype=uf.dtype, device=u.device) \
        if h0 is None else h0.to(uf.dtype)
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


def ssm_scan_states_plain(u, dt, B_, C_, A, D, chunk: int = 16,
                          slots: Optional[int] = None) -> torch.Tensor:
    """The states of `selective_scan` at the start of every ``chunk`` steps,
    h_{chunk k - 1} for k = 0 .. ceil(T / chunk) - 1 (zeros for k = 0):
    (B, ceil(T / chunk), d, slots) float32 (float64 for float64 inputs),
    state slots past N zero. What kernel K6 stores for its backward when
    autograd runs it (``slots`` = 16)."""
    Bsz, T, d = u.shape
    N = A.shape[1]
    uf, dtf, bf = (_work(a) for a in (u, dt, B_))
    Af = _work(A)
    h = torch.zeros((Bsz, d, N), dtype=uf.dtype, device=u.device)
    out = torch.zeros((Bsz, -(-T // chunk), d, slots or N), dtype=uf.dtype,
                      device=u.device)
    for t in range(T):
        if t % chunk == 0:
            out[:, t // chunk, :, :N] = h
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
    return out


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


def ssm_scan_bwd_plain(u, dt, B_, C_, A, D, dy):
    """The plain backward of `ssm_scan_ref`: the explicit reverse scan that
    kernel K6's backward (``csrc/ssm_scan_bwd.cu``) computes, in float32
    (float64 for float64 inputs). Given dy (B, T, d), returns (du, ddt, dB_,
    dC_, dA, dD) in the dtypes of (u, dt, B_, C_, A, D):

        dh_t  = dy_t C_t + exp(dt_{t+1} A) dh_{t+1}
        du_t  = dy_t D + dt_t sum_n dh_t B_t
        ddt_t = sum_n dh_t (A exp(dt_t A) h_{t-1} + u_t B_t)
        dA    = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1},  dD = sum dy u
        dB_t  = sum_c dh_t dt_t u_t,  dC_t = sum_c dy_t h_t

    It keeps every state (B, T, d, N) of the forward walk."""
    Bsz, T, d = u.shape
    uf, dtf, dyf, bf, cf, Af, Df = (_work(a) for a in (u, dt, dy, B_, C_, A,
                                                        D))
    h = torch.zeros((Bsz, d, Af.shape[1]), dtype=uf.dtype, device=u.device)
    hs = []
    for t in range(T):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h)
    du, ddt, dB, dC = [None] * T, [None] * T, [None] * T, [None] * T
    dA = torch.zeros_like(Af)
    for t in reversed(range(T)):
        dh = dyf[:, t, :, None] * cf[:, t, None, :] + g
        hprev = hs[t - 1] if t > 0 else torch.zeros_like(h)
        e = torch.exp(dtf[:, t, :, None] * Af)
        eh = e * hprev
        ub = uf[:, t, :, None] * bf[:, t, None, :]
        ddt[t] = (dh * (Af * eh + ub)).sum(-1)
        dA = dA + (dh * dtf[:, t, :, None] * eh).sum(0)
        du[t] = dyf[:, t] * Df + dtf[:, t] * (dh * bf[:, t, None, :]).sum(-1)
        dB[t] = (dh * (dtf[:, t] * uf[:, t])[..., None]).sum(1)
        dC[t] = (dyf[:, t, :, None] * hs[t]).sum(1)
        g = e * dh
    dD = (dyf * uf).sum((0, 1))

    def stack(xs, like):
        out = torch.stack(xs, dim=1) if xs else like.float().new_zeros(
            like.shape)
        return out.to(like.dtype)

    return (stack(du, u), stack(ddt, dt), stack(dB, B_), stack(dC, C_),
            dA.to(A.dtype), dD.to(D.dtype))


def ssm_scan_bwd_tolerance(u, dt, B_, C_, A, D, dy, refs):
    """Elementwise bounds on |kernel - plain version| of each of the six
    gradients (du, ddt, dB_, dC_, dA, dD) for the same inputs; ``refs`` are
    the plain version's outputs.

    Both sides run the same recurrences in float32 in other orders. Per
    side, with eps the float32 unit roundoff doubled (one ulp):

    * The states. `ssm_scan_tolerance` bounds the two sides' forward states
      apart by 16 eps E_t (its magnitude recurrences H_t >= |h_t| and
      E_t); each side is within 8 eps E_t of the exact state. The backward
      rebuilds them with the forward's instructions (the kernel with
      ex2.approx.ftz, within 2 ulp and counted there), so err_h <= 8 eps E.
    * The exps. The kernel takes exp(dt A) as 2^(dt (A log2 e)) by
      ex2.approx.ftz.f32: 2 ulp, plus 1.5 eps |dt A| relative from the
      roundings of log2 e, A log2 e and dt (A log2 e); the plain version's
      exp is within 1 ulp plus 0.5 eps |dt A| for dt A. So each side's
      exp(dt A) is within rel_e = (2 + 1.5 |dt A|) eps of exact.
    * The adjoint dh_t = dy_t C_t + e_{t+1} dh_{t+1} is contractive
      (e <= 1). With Gm_t = |dy_t C_t| + e_{t+1} Gm_{t+1} >= |dh_t|, the
      step's product e_{t+1} dh_{t+1} is off by at most (rel_e_{t+1} + eps)
      e_{t+1} Gm_{t+1} besides the carried error, and its sum with
      dy_t C_t adds 2 eps Gm_t, so err_dh_t <= Eg_t with
      Eg_t = e_{t+1} (Eg_{t+1} + (rel_e_{t+1} + eps) Gm_{t+1}) + 2 eps Gm_t.
    * Each gradient is a sum of products of these: a product's error is at
      most its factors' errors times the other factors' magnitudes, plus
      one rounding a factor; a float32 sum of m terms, in any order, is
      within (m - 1) eps of the sum of their magnitudes. So, per side:
      du_t:  |dt| sum_n Eg |B| + (N + 3) eps (|dy D| + |dt| sum_n Gm |B|)
      ddt_t: sum_n [Eg (|A| e |h_{t-1}| + |u B|) + Gm |A| e (err_h_{t-1}
             + rel_e |h_{t-1}|)] + (N + 4) eps sum_n Gm (|A| e |h_{t-1}|
             + |u B|)
      dA:    sum_{b,t} |dt| e [Eg |h_{t-1}| + Gm (err_h_{t-1} + rel_e
             |h_{t-1}|)] + (B T + 3) eps sum_{b,t} Gm |dt| e |h_{t-1}|
      dD:    (B T) eps sum_{b,t} |dy u|
      dB_t:  sum_c Eg |dt u| + (d + 2) eps sum_c Gm |dt u|
      dC_t:  sum_c |dy| err_h_t + (d + 1) eps sum_c |dy| H_t
    The bound is twice that (two sides), 1% more for the float32 rounding
    of the bound's own sums, and for a bf16 output (du, dB_, dC_) one
    rounding of each side, 1.01 * 2^-7 |ref|.

    It needs every state's magnitude (B, T, d, N float32: 1 GiB for
    falcon-mamba-7b at B 2, T 1024)."""
    eps = torch.finfo(torch.float32).eps
    Bsz, T, d = u.shape
    N = A.shape[1]
    uf, dtf, dyf = u.float(), dt.float(), dy.float()
    bf, cf = B_.float().abs(), C_.float().abs()
    Af = A.float()
    Aa, Da = Af.abs(), D.float().abs()
    dev = u.device
    # forward magnitudes: H_t >= |h_t|, err_h_t <= 8 eps E_t (per side)
    H = torch.zeros((Bsz, d, N), dtype=torch.float32, device=dev)
    E = torch.zeros_like(H)
    Hs, Es = [], []
    for t in range(T):
        e = torch.exp(dtf[:, t, :, None] * Af)
        inc = (dtf[:, t] * uf[:, t]).abs()[..., None] * bf[:, t, None, :]
        E = e * E + H + inc
        H = e * H + inc
        Hs.append(H)
        Es.append(E)
    zero = torch.zeros_like(H)
    Gm = torch.zeros_like(H)     # e_{t+1} Gm_{t+1}, carried
    Eg = torch.zeros_like(H)     # the carried part of Eg_t
    t_du, t_ddt, t_dB, t_dC = [None] * T, [None] * T, [None] * T, [None] * T
    t_dA = torch.zeros((d, N), dtype=torch.float32, device=dev)
    sum_dA = torch.zeros_like(t_dA)
    for t in reversed(range(T)):
        dtA = dtf[:, t, :, None] * Af
        e = torch.exp(dtA)
        rel_e = (2 + 1.5 * dtA.abs()) * eps
        gm = (dyf[:, t, :, None] * cf[:, t, None, :]).abs() + Gm
        eg = Eg + 2 * eps * gm
        hp = Hs[t - 1] if t > 0 else zero
        ehp = 8 * eps * Es[t - 1] if t > 0 else zero
        adt = dtf[:, t].abs()[..., None]
        ub = (uf[:, t].abs()[..., None]) * bf[:, t, None, :]
        aeh = Aa * e * hp
        t_du[t] = adt[..., 0] * (eg * bf[:, t, None, :]).sum(-1) + (N + 3) \
            * eps * ((dyf[:, t] * Da).abs()
                     + adt[..., 0] * (gm * bf[:, t, None, :]).sum(-1))
        t_ddt[t] = (eg * (aeh + ub) + gm * Aa * e * (ehp + rel_e * hp)
                    ).sum(-1) + (N + 4) * eps * (gm * (aeh + ub)).sum(-1)
        t_dA = t_dA + (adt * e * (eg * hp + gm * (ehp + rel_e * hp))).sum(0)
        sum_dA = sum_dA + (gm * adt * e * hp).sum(0)
        dtu = (dtf[:, t] * uf[:, t]).abs()[..., None]
        t_dB[t] = (eg * dtu).sum(1) + (d + 2) * eps * (gm * dtu).sum(1)
        ady = dyf[:, t].abs()[..., None]
        t_dC[t] = (ady * 8 * eps * Es[t]).sum(1) \
            + (d + 1) * eps * (ady * Hs[t]).sum(1)
        Gm = e * gm
        Eg = e * (eg + (rel_e + eps) * gm)
    t_dA = t_dA + (Bsz * T + 3) * eps * sum_dA
    t_dD = Bsz * T * eps * (dyf * uf).abs().sum((0, 1))

    def done(parts, ref):
        tol = 2.02 * (torch.stack(parts, dim=1) if isinstance(parts, list)
                      else parts)
        if ref.dtype == torch.bfloat16:
            tol = tol + 1.01 * 2.0 ** -7 * ref.float().abs()
        return tol

    du_r, ddt_r, dB_r, dC_r, dA_r, dD_r = refs
    return (done(t_du, du_r), done(t_ddt, ddt_r), done(t_dB, dB_r),
            done(t_dC, dC_r), done(t_dA, dA_r), done(t_dD, dD_r))
