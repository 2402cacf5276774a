"""The plain PyTorch version of kernel K5
(`repro.kernels.flash_attention.ref`)."""
from typing import Optional

import torch


def _work(a: torch.Tensor) -> torch.Tensor:
    """``a`` in the type the plain versions compute in: float32, or float64
    for float64 inputs (the tests' exact reference)."""
    return a if a.dtype == torch.float64 else a.float()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, T, d); k/v: (BH, S, d) -> (BH, T, d) in q's dtype. Scores,
    softmax and the product with v in float32 (float64 for float64 inputs);
    query t sees key s when ``s <= t`` (causal) and ``s > t - window``
    (window > 0)."""
    T, S, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("btd,bsd->bts", _work(q), _work(k)) * (d ** -0.5)
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
    return torch.einsum("bts,bsd->btd", p, _work(v)).to(q.dtype)


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


# ---------------------------------------------------------------------------
# the backward: model layout, q (B, T, H, hd), k/v (B, S, KV, hd)
# ---------------------------------------------------------------------------


def _visible(T: int, S: int, causal: bool, window: int, device):
    qp = torch.arange(T, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


def _heads(a: torch.Tensor, G: int) -> torch.Tensor:
    """(B, L, heads, hd) -> (B, heads * G, L, hd) in the working type, each
    head repeated over its query group."""
    return _work(a).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)


def _scores(q, k, causal, window, softcap):
    """(raw, x, tanh or None, visible mask) of the model layout, float32:
    raw = q k^T / sqrt(hd) (B, H, T, S), x = softcap(raw)."""
    G = q.shape[2] // k.shape[2]
    raw = torch.einsum("bhtd,bhsd->bhts", _heads(q, 1), _heads(k, G)) \
        * (q.shape[-1] ** -0.5)
    th = torch.tanh(raw / softcap) if softcap else None
    x = th * softcap if softcap else raw
    return raw, x, th, _visible(q.shape[1], k.shape[1], causal, window,
                                q.device)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """lse (B, H, T) float32, what K5's forward writes beside o: log sum_s
    exp(x_ts) over the keys row t sees, x the scaled and softcapped score,
    in natural log units; +inf for a row that sees no key."""
    _, x, _, ok = _scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(torch.where(ok, x, -torch.inf), dim=-1)
    return torch.where(torch.isneginf(lse), torch.inf, lse)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of o = softmax(x) v for the gradient ``do``, in the
    model's layout and the inputs' dtypes, by the formulas of K5's backward
    kernel (``csrc/flash_attention_bwd.cu``), in float32 (float64 for
    float64 inputs): P recomputed from
    the forward's ``lse`` (B, H, T), D = rowsum(do o),
    dS = P (do v^T - D) (1 - tanh^2(raw / cap)) with a softcap,
    dv = P^T do and dk = dS^T q / sqrt(hd) summed over each KV head's query
    group, dq = dS k / sqrt(hd)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    _, x, th, ok = _scores(q, k, causal, window, softcap)
    p = torch.where(ok, torch.exp(x - lse.to(x.dtype)[..., None]),
                    torch.zeros_like(x))
    dof = _heads(do, 1)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, _heads(v, G))
    delta = (dof * _heads(o, 1)).sum(-1)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1 - th * th)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, _heads(q, 1)) * scale
    dq = torch.einsum("bhts,bhsd->bhtd", ds, _heads(k, G)) * scale

    def per_kv(a):                        # (B, H, S, hd) -> (B, S, KV, hd)
        return a.reshape(B, KV, G, S, hd).sum(2).permute(0, 2, 1, 3)

    return (dq.permute(0, 2, 1, 3).to(q.dtype), per_kv(dk).to(k.dtype),
            per_kv(dv).to(v.dtype))


def flash_attention_bwd_tolerance(q, k, v, o, do, lse, refs, *,
                                  causal: bool = True, window: int = 0,
                                  softcap: float = 0.0):
    """Elementwise bounds (on dq, dk, dv) on |kernel - plain version| of
    the backward for the same inputs; ``refs`` are the plain version's
    (dq, dk, dv).

    Both sides take the same q, k, v, o, do and lse and compute in float32;
    the plain version (like the kernel's CUDA-core body) recomputes P in
    float32 from lse, so no bf16 rounding of P enters (the wgmma body's
    roundings are the bf16 terms at the end). Per side, with eps one
    float32 ulp and a = hd^-1/2, for a visible pair (t, s):

    * raw = a q_t . k_s: hd products summed in some order, within
      (hd + 1) eps M_ts, M = a |q| |k|^T. The softcap's x = cap tanh(raw /
      cap) has slope at most 1 and adds 4 eps |x| (the division, tanh
      within 2 ulp, the product): err_x <= (hd + 1) eps M + 4 eps |x|.
    * P = exp(x - lse): the difference rounds by eps |x - lse| and exp is
      within 2 ulp: rel_P = err_x + eps |x - lse| + 2 eps.
    * dP = do_t . v_s within hd eps N_ts, N = |do| |v|^T; D = do_t . o_t
      within hd eps W_t, W = sum_d |do o|.
    * dS = P (dP - D) f, f = 1 - tanh^2 (1 without a softcap, whose f is off
      by at most 2 |tanh| (err_x / cap + 2 eps |tanh|)): err_dS <=
      P f (rel_P |dP - D| + hd eps (N + W) + 3 eps |dP - D|)
      + P |dP - D| err_f.
    * dv_s = sum_t P do_t over at most n = T G rows (the group's heads),
      dk_s = a sum_t dS q_t likewise, dq_t = a sum_s dS k_s over at most S
      keys: a sum of m products is within m eps of the sum of their
      magnitudes, beside the factors' errors:
      dv: sum_t rel_P P |do| + (n + 1) eps sum_t P |do|
      dk: a sum_t err_dS |q| + (n + 2) eps a sum_t |dS| |q|
      dq: a sum_s err_dS |k| + (S + 2) eps a sum_s |dS| |k|
    The bound is twice that (two sides), 1% more for the float32 rounding
    of the bound's own sums, and for a bf16 output one rounding of each
    side, 1.01 * 2^-7 |ref|.

    Inputs that take the backward's wgmma body (`takes_wgmma_bwd`: bf16 at
    head_dim 64, 128, 192 or 256 whose strides TMA can read) take further
    terms for its roundings (one side only: the plain version, like the
    CUDA-core body, keeps P and dS in float32), with 1% slack each for the
    second-order products of these roundings with the errors above:

    * P in the log2 domain: the kernel takes P = exp2f(y) with y =
      fma(s, c, -L), s = q_t . k_s, c = d^-1/2 log2 e and L = lse log2 e
      each rounded once to float32 from log2 e rounded once (the softcap's
      y = fma(x, log2 e, -L)). Against (x - lse) log2 e, y is off by at
      most log2 e (eps |x| + eps |lse| + eps/2 |x - lse|), and exp2 turns
      an error of y into ln 2 times as much relative error of P: rel_P
      gains eps (|x| + |lse|) (the eps/2 |x - lse| lies inside the eps
      |x - lse| above). exp2f's 2 ulp are the 2 eps above. This term
      enters the two-sided sums like the others.
    * P rounded to bf16 before dv += P^T do: round to nearest moves each
      P by at most 2^-8 P, so dv_s moves by at most 2^-8 sum_t P |do|.
    * dS rounded to bf16 before dk += dS^T q and dq += dS k: dk_s moves by
      at most 2^-8 a sum_t |dS| |q|, dq_t by 2^-8 a sum_s |dS| |k|.

    Every other input keeps the bound above. It materializes a handful
    of (B, H, T, S) float32 matrices."""
    # imported here: ops imports this module
    from repro_torch.kernels.flash_attention.ops import takes_wgmma_bwd
    eps = torch.finfo(torch.float32).eps
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    a = hd ** -0.5
    wgmma = takes_wgmma_bwd(q, k, v, o, do)
    raw, x, th, ok = _scores(q, k, causal, window, softcap)
    del raw
    qa, ka = _heads(q, 1).abs(), _heads(k, G).abs()
    va, doa = _heads(v, G).abs(), _heads(do, 1).abs()
    zero = torch.zeros_like(x)
    M = torch.einsum("bhtd,bhsd->bhts", qa, ka) * a
    err_x = (hd + 1) * eps * M + 4 * eps * x.abs()
    del M
    lsef = lse.float()[..., None]
    lse_fin = torch.where(torch.isinf(lsef), torch.zeros_like(lsef), lsef)
    p = torch.where(ok, torch.exp(x - lsef), zero)
    rel_p = err_x + eps * (x - lse_fin).abs() + 2 * eps
    if wgmma:
        rel_p = rel_p + eps * (x.abs() + lse_fin.abs())
    dof = _heads(do, 1)
    dmd = (torch.einsum("bhtd,bhsd->bhts", dof, _heads(v, G))
           - (dof * _heads(o, 1)).sum(-1)[..., None]).abs()
    NW = torch.einsum("bhtd,bhsd->bhts", doa, va) \
        + (doa * _heads(o, 1).abs()).sum(-1)[..., None]
    f = 1 - th * th if softcap else torch.ones_like(x)
    err_ds = p * f * (rel_p * dmd + hd * eps * NW + 3 * eps * dmd)
    if softcap:
        err_ds = err_ds + p * dmd * 2 * th.abs() * (
            err_x / softcap + 2 * eps * th.abs())
    ads = p * dmd * f
    del NW, dmd, x
    n = T * G

    def per_kv(a_):
        return a_.reshape(B, KV, G, S, hd).sum(2).permute(0, 2, 1, 3)

    p_do = torch.einsum("bhts,bhtd->bhsd", p, doa)
    ds_q = torch.einsum("bhts,bhtd->bhsd", ads, qa)
    ds_k = torch.einsum("bhts,bhsd->bhtd", ads, ka).permute(0, 2, 1, 3)
    t_dv = per_kv(torch.einsum("bhts,bhtd->bhsd", rel_p * p, doa)
                  + (n + 1) * eps * p_do)
    t_dk = per_kv(a * torch.einsum("bhts,bhtd->bhsd", err_ds, qa)
                  + (n + 2) * eps * a * ds_q)
    t_dq = (a * torch.einsum("bhts,bhsd->bhtd", err_ds, ka)
            ).permute(0, 2, 1, 3) + (S + 2) * eps * a * ds_k
    # the bf16 roundings of P and dS (wgmma body), one side
    u = 2.0 ** -8 if wgmma else 0.0
    extra = (u * a * ds_k, u * a * per_kv(ds_q), u * per_kv(p_do))

    def done(t, x, ref):
        t = 2.02 * t + 1.01 * x
        if ref.dtype == torch.bfloat16:
            t = t + 1.01 * 2.0 ** -7 * ref.float().abs()
        return t

    return tuple(done(t, x, r)
                 for t, x, r in zip((t_dq, t_dk, t_dv), extra, refs))


def flash_attention_lse_tolerance(q, k, lse, *, softcap: float = 0.0
                                  ) -> torch.Tensor:
    """Bound on |kernel - plain version| of the forward's lse (B, H, T).
    Each score is within (hd + 1) eps a max_s |q_t| . |k_s| of exact on
    either side (the wgmma body sums bf16 products exactly into float32,
    the CUDA-core body and the plain version in float32), plus 4 eps |x|
    for a softcap; lse = log sum exp moves by at most the largest score
    error, and its own roundings (the running max's rescalings, the sum,
    the log, the wgmma body's log2 domain and ln 2) add at most 8 eps
    (|lse| + 1). Twice that for two sides, 1% slack."""
    eps = torch.finfo(torch.float32).eps
    hd = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    M = torch.einsum("bhtd,bhsd->bhts", _heads(q, 1).abs(),
                     _heads(k, G).abs()).amax(-1) * hd ** -0.5
    err = (hd + 1) * eps * M
    if softcap:
        err = err + 4 * eps * softcap
    lsef = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse.float())
    return 2.02 * (err + 8 * eps * (lsef.abs() + 1))
