"""The plain backward versions of K5 (`flash_attention_bwd_plain`) and K6
(`ssm_scan_bwd_plain`), which the backward kernels are held against on the
card, against autograd of the plain forward versions (float64, tight) and
against `jax.grad` of the JAX package's attention oracle and selective scan
(float32). The same numpy inputs, made from a seed, go to both sides. Also:
the tolerances of the backward kernels cover the float32 plain versions'
own rounding against float64, the tile ranges the K5 backward kernel walks
cover every visible pair, and on the CPU the wrappers keep a gradient with
no kernel launched.

Tolerances: float64 against autograd 1e-10 (the same formulas in another
order); float32 against `jax.grad` 1e-4 relative to the gradient's largest
value (both sides sum hd or T products in float32, in other orders, and the
jnp side differentiates the softmax where the plain version recomputes P
from lse); lse against jax's logsumexp 1e-5."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention_ref as jax_fref  # noqa: E402,E501
from repro.nn.ssm import _selective_scan as jax_scan  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ssm_scan as TSS  # noqa: E402

# name: (B, T, H, KV, hd, window, softcap), the cases of
# tests/test_torch_lm_kernels.py
CASES = {
    "gqa1": (1, 64, 4, 4, 16, 0, 0.0),
    "gqa2_ragged": (2, 50, 4, 2, 32, 0, 0.0),
    "gqa4_ragged": (1, 96, 4, 1, 16, 0, 0.0),
    "window": (1, 128, 2, 2, 16, 32, 0.0),
    "window_ragged_gqa2": (1, 77, 4, 2, 16, 20, 0.0),
    "softcap": (1, 64, 2, 1, 16, 0, 50.0),
    "softcap_window_gqa4": (2, 45, 8, 2, 32, 16, 30.0),
}


def _qkv_do(B, T, H, KV, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, H, hd)), r.normal(size=(B, T, KV, hd)),
            r.normal(size=(B, T, KV, hd)), r.normal(size=(B, T, H, hd)))


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


def _close(got, want, rtol):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _jax_ref(q, k, v, *, window, softcap):
    """The JAX oracle in the model's layout (GQA folded as its ops.py)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV

    def fold(a):
        return jnp.broadcast_to(a.transpose(0, 2, 1, 3)[:, :, None],
                                (B, KV, G, S, hd)).reshape(B * H, S, hd)

    o = jax_fref(q.transpose(0, 2, 1, 3).reshape(B * H, T, hd), fold(k),
                 fold(v), causal=True, window=window, softcap=softcap)
    return o.reshape(B, H, T, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bwd_plain_matches_autograd_float64(case):
    B, T, H, KV, hd, window, cap = CASES[case]
    qn, kn, vn, don = _qkv_do(B, T, H, KV, hd, seed=len(case) + T)
    q, k, v = (_t(a, grad=True) for a in (qn, kn, vn))
    kw = dict(causal=True, window=window, softcap=cap)
    o = TFA.flash_attention_plain(q, k, v, **kw)
    want = torch.autograd.grad(o, (q, k, v), _t(don))
    lse = TFA.flash_attention_lse_plain(q.detach(), k.detach(), v.detach(),
                                        **kw)
    got = TFA.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), _t(don), lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        _close(g, w.numpy(), 1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bwd_plain_matches_jax_grad(case):
    B, T, H, KV, hd, window, cap = CASES[case]
    qn, kn, vn, don = (a.astype(np.float32) for a in
                       _qkv_do(B, T, H, KV, hd, seed=len(case) + T))

    def f(q, k, v):
        o = _jax_ref(q, k, v, window=window, softcap=cap)
        return jnp.sum(o * don)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (qn, kn, vn)))
    kw = dict(causal=True, window=window, softcap=cap)
    q, k, v, do = (_t(a, torch.float32) for a in (qn, kn, vn, don))
    o, lse = TFA.flash_attention_with_lse(q, k, v, **kw)
    got = TFA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, np.asarray(w), 1e-4)
    jlse = jax.nn.logsumexp(
        jnp.where(jnp.asarray(_visible_np(T, window))[None, None],
                  _jax_scores(qn, kn, cap), -jnp.inf), axis=-1)
    _close(lse, np.asarray(jlse), 1e-5)


def _visible_np(T, window):
    t, s = np.arange(T)[:, None], np.arange(T)[None, :]
    ok = s <= t
    return ok & (s > t - window) if window else ok


def _jax_scores(q, k, cap):
    """softcap(q k^T / sqrt(hd)) (B, H, T, S) in jnp, KV heads repeated."""
    G = q.shape[2] // k.shape[2]
    kk = jnp.repeat(jnp.asarray(k), G, axis=2)
    s = jnp.einsum("bthd,bshd->bhts", jnp.asarray(q), kk) \
        * (q.shape[-1] ** -0.5)
    return jnp.tanh(s / cap) * cap if cap else s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa2_ragged", "softcap_window_gqa4",
                                  "window_ragged_gqa2"])
def test_flash_attention_bwd_tolerance_covers_float32_rounding(case, dtype):
    """The bound is for two float32 computations of the same function; the
    float32 plain version against the float64 one is one of them against
    exact, so it must stay inside (bf16: the bf16 output's own rounding
    too)."""
    B, T, H, KV, hd, window, cap = CASES[case]
    dt = getattr(torch, dtype)
    arrs = [_t(a, torch.float32).to(dt)
            for a in _qkv_do(B, T, H, KV, hd, seed=3 + T)]
    kw = dict(causal=True, window=window, softcap=cap)
    q, k, v, do = arrs
    o, lse = TFA.flash_attention_with_lse(q, k, v, **kw)
    got = TFA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    exact = TFA.flash_attention_bwd_plain(
        *(a.double() for a in (q, k, v, o, do)), lse.double(), **kw)
    tols = TFA.flash_attention_bwd_tolerance(q, k, v, o, do, lse, got, **kw)
    for g, e, tol in zip(got, exact, tols):
        assert bool(((g.double() - e).abs() <= tol).all())
        assert bool((tol < 0.05 * e.abs().max() + 1e-3).all())
    lse_tol = TFA.flash_attention_lse_tolerance(q, k, lse, softcap=cap)
    lse64 = TFA.flash_attention_lse_plain(q.double(), k.double(), v.double(),
                                          **kw)
    assert bool(((lse.double() - lse64).abs() <= lse_tol).all())


def _fma(a, b, c):
    """a b + c rounded once to float32 (a, b float32: their product is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _flash_bwd_wgmma_order(q, k, v, o, do, lse, *, window, softcap,
                           split=1):
    """The arithmetic of the backward's wgmma body (``csrc/
    flash_attention_bwd.cu``) in plain PyTorch, causal: S = q k^T and
    dP = do v^T of bf16 inputs summed in float32; P = exp2f(fma(s,
    d^-1/2 log2 e, -lse log2 e)) (softcap: fma(cap tanh(s d^-1/2 / cap),
    log2 e, -lse log2 e)), the constants rounded to float32 as the kernel
    rounds them; D = rowsum(do o) and dS = P (dP - D) (1 - tanh^2) in
    float32; P rounded to bf16 before dv = P^T do, dS before dk = dS^T q
    and dq = dS k; dk and dq scaled by d^-1/2 after their sums; outputs
    in bf16. With ``split`` > 1 (head_dim 192 and 256, `bwd_head_split`)
    dk and dv sum each split's heads [j G // n, (j + 1) G // n) into a
    float32 partial, then the partials in j's order."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))
    scale_log2 = scale * log2e

    def heads(a, g):
        return a.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)

    qf, kf, vf = heads(q, 1), heads(k, G), heads(v, G)
    of, dof = heads(o, 1), heads(do, 1)
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    l2 = (lse.float() * log2e)[..., None].expand_as(s)
    if softcap:
        th = torch.tanh(s * scale / softcap)
        fac = 1 - th * th
        y = _fma(th * softcap, log2e.expand_as(s), -l2)
    else:
        fac = torch.ones_like(s)
        y = _fma(s, scale_log2.expand_as(s), -l2)
    t_, s_ = torch.arange(T)[:, None], torch.arange(S)[None, :]
    ok = s_ <= t_
    if window:
        ok &= s_ > t_ - window
    p = torch.where(ok, torch.exp2(y), torch.zeros_like(y))
    ds = p * (dp - (dof * of).sum(-1)[..., None]) * fac
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()

    def per_kv(a):
        a = a.reshape(B, KV, G, S, hd)
        parts = [a[:, :, j * G // split:(j + 1) * G // split].sum(2)
                 for j in range(split)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total.permute(0, 2, 1, 3)

    dv = per_kv(pb.transpose(-1, -2) @ dof)
    dk = per_kv(dsb.transpose(-1, -2) @ qf) * scale
    dq = (dsb @ kf).permute(0, 2, 1, 3) * scale
    return tuple(a.to(torch.bfloat16) for a in (dq, dk, dv))


# name: (B, T, H, KV, hd, window, softcap) at the two-warpgroup body's
# head_dims: causal, a window, a softcap, 16 query heads on one KV head
# (the head split) and T not a multiple of the 64-row tiles
WIDE_CASES = {
    "hd192_gqa2_ragged": (1, 70, 4, 2, 192, 0, 0.0),
    "hd192_softcap_window_g16_kv1": (1, 50, 16, 1, 192, 16, 30.0),
    "hd256_window_ragged": (1, 77, 4, 4, 256, 20, 0.0),
    "hd256_softcap_gqa2": (1, 64, 4, 2, 256, 0, 50.0),
    "hd256_g16_kv1_window_ragged": (1, 90, 16, 1, 256, 32, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(WIDE_CASES))
def test_flash_attention_bwd_tolerance_covers_the_wgmma_bodys_roundings(
        case):
    """An emulation of the wgmma body's arithmetic (bf16 P and dS, exp2 in
    the log2 domain) against the float64 plain version stays inside
    `flash_attention_bwd_tolerance` for inputs that take that body, whose
    bf16 terms are what it needs, and the bound stays tight. The cases run
    at the body's head_dims (16 -> 64, 32 -> 128; the wide cases at 192
    and 256, with the head split `bwd_head_split` gives the H100)."""
    if case in CASES:
        B, T, H, KV, hd, window, cap = CASES[case]
        hd *= 4
    else:
        B, T, H, KV, hd, window, cap = WIDE_CASES[case]
    q, k, v, do = (_t(a, torch.float32).to(torch.bfloat16)
                   for a in _qkv_do(B, T, H, KV, hd, seed=5 + T + hd))
    kw = dict(causal=True, window=window, softcap=cap)
    o, lse = TFA.flash_attention_with_lse(q, k, v, **kw)
    assert TFA.takes_wgmma_bwd(q, k, v, o, do)
    split = TFA.bwd_head_split(T, B, H, KV, 132) if hd > 128 else 1
    # few key tiles: every wide case with a group of heads splits them
    assert (split > 1) == (hd > 128 and H > KV)
    got = _flash_bwd_wgmma_order(q, k, v, o, do, lse, window=window,
                                 softcap=cap, split=split)
    exact = TFA.flash_attention_bwd_plain(
        *(a.double() for a in (q, k, v, o, do)), lse.double(), **kw)
    tols = TFA.flash_attention_bwd_tolerance(q, k, v, o, do, lse, got, **kw)
    for g, e, tol in zip(got, exact, tols):
        assert g.shape == e.shape == tol.shape
        assert bool(((g.double() - e).abs() <= tol).all())
        assert bool((tol < 0.05 * e.abs().max() + 1e-3).all())


def test_flash_attention_bwd_tolerance_takes_the_bf16_terms_with_the_body():
    """The bf16 terms enter only for inputs that take the wgmma body: a
    bf16 view TMA cannot read (the CUDA-core body, which keeps P and dS in
    float32) keeps the bound without them, below the bound of the same
    values laid out contiguously."""
    q, k, v, do = (_t(a, torch.float32).to(torch.bfloat16)
                   for a in _qkv_do(1, 40, 4, 2, 64, seed=9))
    full = torch.zeros((1, 40, 4, 68), dtype=torch.bfloat16)
    full[..., :64] = q
    qv = full[..., :64]
    o, lse = TFA.flash_attention_with_lse(q, k, v)
    ref = TFA.flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert TFA.takes_wgmma_bwd(q, k, v, o, do)
    assert not TFA.takes_wgmma_bwd(qv, k, v, o, do)
    wide = TFA.flash_attention_bwd_tolerance(q, k, v, o, do, lse, ref)
    tight = TFA.flash_attention_bwd_tolerance(qv, k, v, o, do, lse, ref)
    for w, t in zip(wide, tight):
        assert bool((t <= w).all()) and bool((t < w).any())


@pytest.mark.parametrize("T,S,window,causal", [
    (1000, 1000, 0, True), (77, 77, 0, True), (130, 333, 0, False),
    (700, 700, 256, True), (45, 45, 16, True), (200, 200, 100, False),
    (64, 64, 1, True)])
@pytest.mark.parametrize("tile", [64, 32])
def test_flash_attention_bwd_tile_ranges_cover_every_pair(T, S, window,
                                                          causal, tile):
    """The ranges of query tiles the dk/dv kernel walks for a KV tile, and
    of KV tiles the dq kernel walks for a query tile (csrc/
    flash_attention_bwd.cu), each cover every visible (t, s) pair."""
    ok = np.ones((T, S), bool)
    t, s = np.arange(T)[:, None], np.arange(S)[None, :]
    if causal:
        ok &= s <= t
    if window:
        ok &= s > t - window
    n_qt, n_kt = -(-T // tile), -(-S // tile)
    seen_kv = np.zeros_like(ok)
    for kt in range(n_kt):
        k0 = kt * tile
        k_last = min(k0 + tile, S) - 1
        qt_begin = k0 // tile if causal else 0
        qt_end = n_qt
        if window:
            qt_end = min(qt_end, (k_last + window - 1) // tile + 1)
        for qt in range(qt_begin, qt_end):
            seen_kv[qt * tile:(qt + 1) * tile, k0:k0 + tile] = True
    seen_q = np.zeros_like(ok)
    for qt in range(n_qt):
        q0 = qt * tile
        q_last = min(q0 + tile, T) - 1
        kt_end = n_kt
        if causal:
            kt_end = min(kt_end, q_last // tile + 1)
        lo = q0 - window + 1
        kt_begin = lo // tile if window and lo > 0 else 0
        for kt in range(kt_begin, kt_end):
            seen_q[q0:q0 + tile, kt * tile:(kt + 1) * tile] = True
    assert not (ok & ~seen_kv).any() and not (ok & ~seen_q).any()


def test_flash_attention_keeps_a_gradient_on_the_cpu():
    q, k, v = (torch.randn((1, 20, 4, 16), requires_grad=True)
               for _ in range(3))
    reset_launches()
    o = TFA.flash_attention(q, k[:, :, :2], v[:, :, :2])
    assert o.grad_fn is not None
    o.sum().backward()
    assert q.grad is not None and k.grad is not None
    assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_bwd"] == 0


def test_takes_wgmma_bwd_by_type_head_dim_and_strides():
    """The backward's body follows from the tensors alone: bf16 at head_dim
    64, 128, 192 and 256 whose (b, t, head) strides TMA can read takes the
    wgmma body; float32 (192 and 256 too), head_dim 32, and a view whose
    head stride is not a multiple of 8 elements take the CUDA-core body."""
    def five(hd, dt, pad=0):
        full = torch.zeros((2, 10, 6, hd + pad), dtype=dt)
        q, k, v = (full[:, :, 2 * i:2 * i + 2, :hd] for i in range(3))
        return q, k, v, q.contiguous(), q.contiguous()

    for hd, dt, pad, want in ((64, torch.bfloat16, 0, True),
                              (128, torch.bfloat16, 0, True),
                              (128, torch.float32, 0, False),
                              (32, torch.bfloat16, 0, False),
                              (192, torch.bfloat16, 0, True),
                              (256, torch.bfloat16, 0, True),
                              (192, torch.float32, 0, False),
                              (256, torch.float32, 0, False),
                              (64, torch.bfloat16, 4, False),
                              (256, torch.bfloat16, 4, False)):
        assert TFA.takes_wgmma_bwd(*five(hd, dt, pad)) is want


# (S, B, H, KV): the training shapes of gemma2-2b, recurrentgemma-9b and
# deepseek-v2, and small ones with one or two KV heads
SPLIT_SHAPES = [(8192, 1, 8, 4), (4096, 1, 16, 1), (1024, 1, 128, 128),
                (2048, 1, 16, 1), (700, 1, 16, 1), (90, 1, 16, 1),
                (130, 2, 12, 2), (64, 1, 8, 1)]


@pytest.mark.parametrize("S,B,H,KV", SPLIT_SHAPES)
def test_bwd_head_split_fills_the_card_and_covers_every_head_once(S, B, H,
                                                                  KV):
    """The head split of the two-warpgroup dk/dv kernel (`bwd_head_split`,
    mirrored by the kernel's block walk): at least 132 blocks (the H100's
    SMs) or every head a block of its own, no more splits than that needs;
    the kernel's blocks (KV tile first, then (b, KV head), then split)
    cover every (b, head, KV tile) exactly once; and partials summed in
    split order equal the unsplit sum over the group's heads to the bit in
    float32 (integer-valued terms, exact in any order, so only a term
    missed or taken twice could differ)."""
    sms, G = 132, H // KV
    n = TFA.bwd_head_split(S, B, H, KV, sms)
    n_kt = -(-S // 64)
    base = n_kt * B * KV
    assert 1 <= n <= G
    assert base * n >= sms or n == G
    assert n == 1 or base * (n - 1) < sms
    if (S, B, H, KV) == (4096, 1, 16, 1):
        assert n == 3          # recurrentgemma-9b: 192 blocks, not 64
    seen = np.zeros((B, H, n_kt), np.int64)
    r = np.random.default_rng(S + H)
    terms = r.integers(-1000, 1000, size=(B, H, n_kt, 8)).astype(np.float32)
    parts = np.zeros((n, B, KV, n_kt, 8), np.float32)
    for blk in range(base * n):
        kt, rest = divmod(blk, B * KV * n)
        bkv, sp = divmod(rest, n)
        b, kvh = divmod(bkv, KV)
        for g in range(sp * G // n, (sp + 1) * G // n):
            seen[b, kvh * G + g, kt] += 1
            parts[sp, b, kvh, kt] += terms[b, kvh * G + g, kt]
    assert (seen == 1).all()
    got = parts[0].copy()
    for sp in range(1, n):
        got += parts[sp]
    want = np.zeros_like(got)
    for g in range(G):       # the unsplit walk: the group's heads in order
        want += terms.reshape(B, KV, G, n_kt, 8)[:, :, g]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_bwd_smem_bytes_fit_a_block():
    """The shared memory a block of the backward's wgmma body asks for
    (`bwd_smem_bytes`, the sizes of ``csrc/flash_attention_bwd.cu``): the
    two-warpgroup kernels at 192 and 256 within a block's 227 KB (one
    block an SM), the one-warpgroup ones at 64 and 128 within half of it
    (two blocks an SM)."""
    limit = 227 * 1024
    for hd in (192, 256):
        assert all(b <= limit for b in TFA.bwd_smem_bytes(hd))
        assert max(TFA.bwd_smem_bytes(hd)) > limit // 2
    for hd in (64, 128):
        assert all(2 * b <= limit for b in TFA.bwd_smem_bytes(hd))
    assert TFA.bwd_smem_bytes(256) == (231488, 230464)


def test_flash_attention_bwd_checks_its_inputs():
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="lse"):
        TFA.flash_attention_bwd(q, q, q, q, q, lse[:, :1])
    with pytest.raises(ValueError, match="lse"):
        TFA.flash_attention_bwd(q, q, q, q, q, lse.double())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFA.flash_attention_bwd(*(a.to("meta") for a in (q, q, q, q, q,
                                                         lse)))


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _scan_inputs(B, T, d, N, seed):
    """As the model makes them: dt = softplus(normal - 1), A = -(1..N)
    times a log-normal factor."""
    r = np.random.default_rng(seed)
    u = r.normal(size=(B, T, d))
    dt = np.log1p(np.exp(r.normal(size=(B, T, d)) - 1.0))
    Bm, Cm = r.normal(size=(B, T, N)), r.normal(size=(B, T, N))
    A = -np.arange(1, N + 1)[None, :] * np.exp(0.3 * r.normal(size=(d, N)))
    return u, dt, Bm, Cm, A, r.normal(size=d), r.normal(size=(B, T, d))


SCAN_SHAPES = [(2, 17, 8, 4), (1, 40, 5, 16), (3, 1, 4, 3), (1, 33, 33, 1)]


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_ssm_scan_bwd_plain_matches_autograd_float64(shape):
    *ins, dyn = _scan_inputs(*shape, seed=sum(shape))
    ts = [_t(a, grad=True) for a in ins]
    y, _ = TSS.selective_scan(*ts)
    want = torch.autograd.grad(y, ts, _t(dyn))
    got = TSS.ssm_scan_bwd_plain(*(t.detach() for t in ts), _t(dyn))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        _close(g, w.numpy(), 1e-10)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_ssm_scan_bwd_plain_matches_jax_grad(shape):
    u, dt, Bm, Cm, A, D, dy = (a.astype(np.float32) for a in
                               _scan_inputs(*shape, seed=sum(shape)))

    def f(*xs):
        y, _ = jax_scan(*xs)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in (u, dt, Bm, Cm, A, D)))
    ins = [_t(a, torch.float32) for a in (u, dt, Bm, Cm, A, D, dy)]
    got = TSS.ssm_scan_bwd(*ins, TSS.ssm_scan_with_states(*ins[:6])[1])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, np.asarray(w), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 8, 16), (1, 70, 5, 4)], ids=str)
def test_ssm_scan_bwd_tolerance_covers_float32_rounding(shape, dtype):
    ins = [_t(a, torch.float32) for a in _scan_inputs(*shape, seed=7)]
    lowp = getattr(torch, dtype)
    u, dt, Bm, Cm, A, D, dy = ins
    u, Bm, Cm, dy = (a.to(lowp) for a in (u, Bm, Cm, dy))
    _, states = TSS.ssm_scan_with_states(u, dt, Bm, Cm, A, D)
    got = TSS.ssm_scan_bwd(u, dt, Bm, Cm, A, D, dy, states)
    exact = TSS.ssm_scan_bwd_plain(*(a.double() for a in
                                     (u, dt, Bm, Cm, A, D, dy)))
    tols = TSS.ssm_scan_bwd_tolerance(u, dt, Bm, Cm, A, D, dy, got)
    for g, e, tol in zip(got, exact, tols):
        assert g.shape == e.shape == tol.shape
        assert bool(((g.double() - e).abs() <= tol).all())


def _tree(xs):
    """A fixed pairwise tree over a power-of-two list: ((x0 + x1) + (x2 +
    x3)) + ..."""
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] for i in range(0, len(xs), 2)]
    return xs[0]


def _scan_bwd_kernel_order(u, dt, Bm, Cm, A, D, dy, chunk=16, lanes=4,
                           slots=16, warp_channels=8, warps=8):
    """The arithmetic of ``csrc/ssm_scan_bwd.cu`` in plain PyTorch: the
    states at chunk starts as K6's forward stores them
    (`ssm_scan_states_plain`), each chunk's states rebuilt from its start,
    the reverse walk in chunks. du and ddt sum over the N (padded to 16)
    states in 4 lanes of 4 values, an fma chain a lane, and the lanes'
    partial sums by the xor tree (p_0 + p_1) + (p_2 + p_3). dB_ and dC_ sum
    over each warp's 8 channels by a tree, then over a block's 8 warps in
    order, then over the blocks of 64 channels in order; dA and dD per
    batch row, then over the rows. exp by exp2 of dt (A log2 e)."""
    Bsz, T, d = u.shape
    N = A.shape[1]
    a2 = A * 1.4426950408889634

    def e_of(t):
        return torch.exp2(dt[:, t, :, None] * a2)

    def pad_n(x):                         # (..., N) -> (..., 16)
        return torch.nn.functional.pad(x, (0, slots - N))

    def lane_sum(x):                      # (B, d, 16) -> (B, d)
        per = lanes * [None]
        for j in range(lanes):
            acc = torch.zeros_like(x[..., 0])
            for q in range(slots // lanes):
                acc = acc + x[..., j * (slots // lanes) + q]
            per[j] = acc
        return _tree(per)

    block = warp_channels * warps
    blocks = -(-d // block)

    def channel_sum(x):                   # (B, d, N) -> (B, N)
        x = torch.nn.functional.pad(x, (0, 0, 0, blocks * block - d))
        total = torch.zeros_like(x[:, 0])
        for blk in range(blocks):
            s_blk = torch.zeros_like(total)
            for w in range(warps):
                c0 = blk * block + w * warp_channels
                s_blk = s_blk + _tree([x[:, c0 + i]
                                       for i in range(warp_channels)])
            total = total + s_blk
        return total

    chunks = -(-T // chunk)
    starts = TSS.ssm_scan_states_plain(u, dt, Bm, Cm, A, D, chunk, slots)
    g = torch.zeros((Bsz, d, N), dtype=u.dtype)
    dA_part = torch.zeros((Bsz, d, N), dtype=u.dtype)
    du, ddt = torch.zeros_like(u), torch.zeros_like(u)
    dB = torch.zeros((Bsz, T, N), dtype=u.dtype)
    dC = torch.zeros_like(dB)
    for k in reversed(range(chunks)):
        t0, t1 = k * chunk, min(T, (k + 1) * chunk)
        h0 = starts[:, k, :, :N]
        hs, h = [], h0
        for t in range(t0, t1):
            h = e_of(t) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t,
                                                                  None, :]
            hs.append(h)
        for t in reversed(range(t0, t1)):
            hprev = hs[t - t0 - 1] if t > t0 else h0
            e = e_of(t)
            dh = dy[:, t, :, None] * Cm[:, t, None, :] + g
            eh = e * hprev
            ddt[:, t] = lane_sum(pad_n(dh * (A * eh + u[:, t, :, None]
                                             * Bm[:, t, None, :])))
            dA_part += dh * dt[:, t, :, None] * eh
            du[:, t] = dt[:, t] * lane_sum(pad_n(dh * Bm[:, t, None, :])) \
                + dy[:, t] * D
            dB[:, t] = channel_sum(dh * (dt[:, t] * u[:, t])[..., None])
            dC[:, t] = channel_sum(dy[:, t, :, None] * hs[t - t0])
            g = e * dh
    return du, ddt, dB, dC, dA_part.sum(0), (dy * u).sum(1).sum(0)


@pytest.mark.parametrize("shape", [(2, 40, 70, 16), (1, 16, 32, 3),
                                   (2, 17, 5, 4), (1, 1, 40, 16)], ids=str)
def test_ssm_scan_bwd_chunked_walk_matches_plain(shape):
    """The kernel's chunked walk (the forward's states every 16 steps,
    rebuilt per chunk, sums over n in 4 lanes, over channels in warps of 8,
    blocks of 64 and their partials) computes the plain backward: in
    float64 they agree to rounding, ragged chunks, states and blocks
    included."""
    ins = [_t(a) for a in _scan_inputs(*shape, seed=11)]
    got = _scan_bwd_kernel_order(*ins)
    want = TSS.ssm_scan_bwd_plain(*ins)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-10)


@pytest.mark.parametrize("shape", [(2, 40, 70, 16), (1, 16, 32, 3),
                                   (2, 17, 5, 4), (1, 1, 40, 16)], ids=str)
def test_ssm_scan_states_plain_are_selective_scans_states(shape):
    """The chunk-start states K6's forward stores for its backward, as the
    plain version gives them (and `ssm_scan_with_states` on the CPU): slot
    k holds `selective_scan`'s state after the first 16 k steps, state
    slots past N zero."""
    ins = [_t(a) for a in _scan_inputs(*shape, seed=13)][:6]
    B, T, d, N = shape
    states = TSS.ssm_scan_states_plain(*ins, 16, 16)
    assert states.shape == (B, -(-T // 16), d, 16)
    assert not bool(states[..., N:].any())
    for k in range(states.shape[1]):
        if k == 0:
            assert not bool(states[:, 0].any())
            continue
        _, h = TSS.selective_scan(*(a[:, :16 * k] if a.dim() == 3 and
                                    a.shape[1] == T else a for a in ins))
        assert torch.equal(states[:, k, :, :N], h)
    y, st32 = TSS.ssm_scan_with_states(*(a.float() for a in ins))
    assert torch.equal(y, TSS.ssm_scan_ref(*(a.float() for a in ins)))
    assert torch.equal(st32, TSS.ssm_scan_states_plain(
        *(a.float() for a in ins), 16, 16))


def test_ssm_scan_keeps_a_gradient_on_the_cpu():
    ins = [_t(a, torch.float32, grad=True)
           for a in _scan_inputs(1, 9, 4, 4, seed=1)[:6]]
    reset_launches()
    y = TSS.ssm_scan(*ins)
    assert y.grad_fn is not None
    y.sum().backward()
    assert all(t.grad is not None for t in ins)
    assert LAUNCHES["ssm_scan"] == LAUNCHES["ssm_scan_bwd"] == 0


def test_ssm_scan_bwd_checks_its_inputs():
    ins = [_t(a, torch.float32) for a in _scan_inputs(1, 4, 4, 2, seed=1)]
    _, states = TSS.ssm_scan_with_states(*ins[:6])
    with pytest.raises(ValueError, match="dy"):
        TSS.ssm_scan_bwd(*ins[:6], ins[6][:, :2], states)
    with pytest.raises(ValueError, match="dy"):
        TSS.ssm_scan_bwd(*ins[:6], ins[6].double(), states)
