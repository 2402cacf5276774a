"""The port's LM kernels K2 (`quant_matmul`) and K5 (`flash_attention`)
against the JAX package's Pallas kernels, run in interpret mode as
``tests/test_kernels.py`` runs them, and against the JAX oracles. The same
numpy inputs, made from a seed, go to both sides; bf16 inputs are rounded to
bf16 once (both frameworks round to nearest even, so both sides see the
same bits). On CPU tensors the wrappers run their plain versions, so the
kernels' launch counts stay 0; the CUDA kernels are held against the plain
versions by the card-only tests in ``tests/test_torch_cuda.py``.

Tolerances: float32 1e-4 against the Pallas kernels (they accumulate
K / block_k partial tiles, or KV tiles with an online softmax, where the
plain versions take one product: a few ulp of reassociation at these
depths) and 1e-5 against the JAX oracles (one product each, summed in
another order); bf16 outputs 3e-2 (one bf16 ulp is 2^-8 relative, and the
Pallas kernels round their per-tile partial results differently)."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402,E501
from repro.kernels.flash_attention import flash_attention_ref as jax_fref  # noqa: E402,E501
from repro.kernels.quant_matmul import quant_matmul as jax_qmm  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul_ref as jax_qref  # noqa: E402,E501
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import quant_matmul as TQM  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
REF_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _full_float32_products():
    """Float32 products in full float32 on both sides, whatever an earlier
    test of the same worker process left set: torch's CPU float32 matmul
    precision "medium" moves the float32 comparisons below some 390 times
    past REF_TOL. Restored after each test."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.tensor(a, dtype=torch.float32).to(torch.bfloat16))
    return jnp.asarray(a, jnp.float32), torch.tensor(a, dtype=torch.float32)


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


# ---------------------------------------------------------------------------
# K2: quant_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (5, 100, 300), (17, 130, 50),
                                   (1, 64, 64), (32, 64, 32)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_plain_matches_pallas_and_ref(M, K, N, bits, dtype):
    r = np.random.default_rng(M * 1000 + K + N + bits)
    qmax = 2 ** (bits - 1) - 1
    x = r.normal(size=(M, K)).astype(np.float32)
    w = r.integers(-qmax, qmax + 1, (K, N)).astype(np.int8)
    s = ((np.abs(r.normal(size=N)) + 0.1) * 0.01).astype(np.float32)
    xj, xt = _pair(x, dtype)
    reset_launches()
    got = TQM.quant_matmul(xt, torch.from_numpy(w), torch.from_numpy(s))
    assert got.dtype == xt.dtype and got.shape == (M, N)
    assert LAUNCHES["quant_matmul"] == 0
    pallas = jax_qmm(xj, jnp.asarray(w), jnp.asarray(s), block_m=32,
                     block_n=32, block_k=64)
    ref = jax_qref(xj, jnp.asarray(w), jnp.asarray(s))
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=REF_TOL[dtype],
                               atol=REF_TOL[dtype])


def test_quant_matmul_checks_its_inputs():
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 16), dtype=torch.int8)
    s = torch.ones(16)
    with pytest.raises(ValueError):
        TQM.quant_matmul(x, w[:4], s)
    with pytest.raises(TypeError):
        TQM.quant_matmul(x, w.float(), s)
    with pytest.raises(TypeError):
        TQM.quant_matmul(x.double(), w, s)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TQM.quant_matmul(x.to("meta"), w.to("meta"), s.to("meta"))


# ---------------------------------------------------------------------------
# K5: flash_attention
# ---------------------------------------------------------------------------


def _qkv(B, T, S, H, KV, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, H, hd)).astype(np.float32),
            r.normal(size=(B, S, KV, hd)).astype(np.float32),
            r.normal(size=(B, S, KV, hd)).astype(np.float32))


def _jax_ref(q, k, v, **kw):
    """The JAX oracle in the model's layout (GQA folded as its ops.py)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV

    def fold(a):
        return jnp.broadcast_to(a.transpose(0, 2, 1, 3)[:, :, None],
                                (B, KV, G, S, hd)).reshape(B * H, S, hd)

    o = jax_fref(q.transpose(0, 2, 1, 3).reshape(B * H, T, hd), fold(k),
                 fold(v), **kw)
    return o.reshape(B, H, T, hd).transpose(0, 2, 1, 3)


CASES = {
    # name: (B, T, H, KV, hd, window, softcap)
    "gqa1": (1, 64, 4, 4, 16, 0, 0.0),
    "gqa2_ragged": (2, 50, 4, 2, 32, 0, 0.0),
    "gqa4_ragged": (1, 96, 4, 1, 16, 0, 0.0),
    "window": (1, 128, 2, 2, 16, 32, 0.0),
    "window_ragged_gqa2": (1, 77, 4, 2, 16, 20, 0.0),
    "softcap": (1, 64, 2, 1, 16, 0, 50.0),
    "softcap_window_gqa4": (2, 45, 8, 2, 32, 16, 30.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(case, dtype):
    B, T, H, KV, hd, window, cap = CASES[case]
    q, k, v = _qkv(B, T, T, H, KV, hd, seed=len(case) + T)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    reset_launches()
    got = TFA.flash_attention(qt, kt, vt, causal=True, window=window,
                              softcap=cap)
    assert got.dtype == qt.dtype and got.shape == (B, T, H, hd)
    assert LAUNCHES["flash_attention"] == 0
    pallas = jax_flash(qj, kj, vj, causal=True, window=window, softcap=cap,
                       block_q=32, block_k=32)
    ref = _jax_ref(qj, kj, vj, causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=REF_TOL[dtype],
                               atol=REF_TOL[dtype])


@pytest.mark.parametrize("T,S", [(50, 50), (40, 70)])
def test_flash_attention_non_causal_padded_matches_oracle(T, S):
    """Fault C2 of the reference: with S not a multiple of block_k and no
    causal mask, the Pallas wrapper lets padded keys take softmax weight.
    The port masks keys beyond S, so it is held against the oracle."""
    q, k, v = _qkv(2, T, S, 4, 2, 16, seed=T + S)
    got = TFA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False)
    ref = _jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


def _wgmma_body(q, k, v, *, causal, window, softcap, block_k):
    """The arithmetic of K5's wgmma body (``csrc/flash_attention.cu``) in
    plain PyTorch: float32 scores of tiles of ``block_k`` keys, an online
    softmax in the log2 domain from a finite running max, P rounded to bf16
    before the product with v (summed in float32), the denominator summed
    from the unrounded float32 p, the output rounded to bf16."""
    B, T, H, hd = q.shape
    S, G = k.shape[1], H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    log2e = 1.4426950408889634
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, hd))
    t = torch.arange(T)[:, None]
    for k0 in range(0, S, block_k):
        kk, vv = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhtd,bhsd->bhts", qf, kk)
        if softcap:
            x = torch.tanh(s * hd ** -0.5 / softcap) * softcap * log2e
        else:
            x = s * (hd ** -0.5 * log2e)
        sp = torch.arange(k0, k0 + kk.shape[2])[None, :]
        ok = sp < S
        if causal:
            ok = ok & (sp <= t)
        if window:
            ok = ok & (sp > t - window)
        x = torch.where(ok, x, torch.full_like(x, -float("inf")))
        m_new = torch.maximum(m, x.amax(-1))
        corr, p = torch.exp2(m - m_new), torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", p.to(torch.bfloat16).float(), vv)
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)


WGMMA_CASES = {
    # name: (T, S, H, KV, hd, causal, window, softcap)
    "hd64_gqa2": (200, 200, 4, 2, 64, True, 0, 0.0),
    "hd128_gqa2_ragged": (150, 150, 2, 1, 128, True, 0, 0.0),
    "hd256_softcap": (130, 130, 2, 1, 256, True, 0, 50.0),
    "hd64_window_softcap": (300, 300, 4, 2, 64, True, 100, 30.0),
    "hd64_non_causal_padded": (100, 200, 4, 4, 64, False, 0, 0.0),
    "hd128_window_gqa8": (160, 160, 8, 1, 128, True, 48, 0.0),
}


def _wgmma_case(case, block_k):
    T, S, H, KV, hd, causal, window, cap = WGMMA_CASES[case]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, T, S, H, KV, hd, seed=T + S + hd))
    kw = dict(causal=causal, window=window, softcap=cap)
    ref = TFA.flash_attention_plain(q, k, v, **kw)
    got = _wgmma_body(q, k, v, block_k=block_k, **kw)
    return q, k, v, ref, (got.float() - ref.float()).abs(), kw


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_flash_attention_tolerance_covers_bf16_p(case, block_k):
    """The wgmma body's rounding of P to bf16 stays within the restated
    `flash_attention_tolerance` of the plain version."""
    q, k, v, ref, diff, kw = _wgmma_case(case, block_k)
    tol = TFA.flash_attention_bound(q, k, v, ref, **kw)
    assert bool((diff <= tol).all()), float((diff / tol).max())


def test_flash_attention_tolerance_needs_the_bf16_p_term():
    """Without the bf16-P term, the bound stated before the wgmma body (the
    float32 reordering and the output's rounding) does not hold for it."""
    eps = torch.finfo(torch.float32).eps
    shares = []
    for case in sorted(WGMMA_CASES):
        _, _, v, ref, diff, _ = _wgmma_case(case, 64)
        old = 2 * v.shape[1] * eps * float(v.float().abs().max()) \
            + 1.01 * 2.0 ** -7 * ref.float().abs()
        shares.append(float((diff / old).max()))
    assert max(shares) > 1.0, shares
    with pytest.raises(ValueError, match="abs_out"):
        TFA.flash_attention_tolerance(v, ref)


def test_flash_attention_checks_its_inputs():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError):
        TFA.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        TFA.flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFA.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------------------
# attend routes the prefill case, and only it, through K5
# ---------------------------------------------------------------------------


@pytest.fixture()
def k5_spy(monkeypatch):
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    return calls


def test_attend_routes_prefill_through_k5_and_decode_not(k5_spy):
    cfg = ARCHS["qwen3-0.6b"].reduced()
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    TT.forward(params, {"tokens": tokens}, cfg)
    assert len(k5_spy) == cfg.num_layers
    assert all(kw == {"causal": True, "window": 0, "softcap": 0.0}
               for _, _, kw in k5_spy)
    k5_spy.clear()
    state = TT.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    for t in range(3):
        _, state = TT.decode_step(params, state, tokens[:, t:t + 1], cfg)
    assert k5_spy == []


def test_attend_cases_off_the_kernel_stay_plain(k5_spy):
    """Calls over a cache (an offset, a valid length, explicit key
    positions) stay plain; every call without one goes through K5, a
    non-causal one (the encoder, cross attention) too."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 8, 4, 2, 16, 3))
    TA.attend(q, k, v, causal=True, q_offset=4)
    TA.attend(q, k, v, causal=True, kv_len=6)
    TA.attend(q, k, v, causal=True, k_positions=torch.arange(8))
    assert k5_spy == []
    TA.attend(q, k, v, causal=True, window=3, softcap=20.0)
    assert k5_spy[0][2] == {"causal": True, "window": 3, "softcap": 20.0}
    TA.attend(q, k, v, causal=False)
    assert k5_spy[1][2] == {"causal": False, "window": 0, "softcap": 0.0}


# ---------------------------------------------------------------------------
# K2's arithmetic on the card: the scale factored out of the k-sum
# ---------------------------------------------------------------------------


def _factored(x, q, s, split):
    """K2's CUDA body (``csrc/quant_matmul.cu``) in plain PyTorch: float32
    sums of x q over ``split`` K-chunks of whole k16 steps, added in chunk
    order, then y = s (sum), rounded to x's type. bf16 x times an int8
    weight is exact in float32, as in the tensor cores."""
    K = x.shape[1]
    steps = (K + 15) // 16
    chunk = 16 * ((steps + split - 1) // split)
    acc = None
    for k0 in range(0, K, chunk):
        part = x[:, k0:k0 + chunk].float() @ q[k0:k0 + chunk].float()
        acc = part if acc is None else acc + part
    return (s[None, :] * acc).to(x.dtype)


# (K, N, K-chunks): qwen3-0.6b's 7 decode shapes and falcon-mamba-7b's
# in_proj, x_proj, dt_proj and out_proj, with the kernel's chunk counts
# (the LM head, 4096 x 65024, is left out for the CPU's memory)
QMM_CARD_SHAPES = [(1024, 2048, 5), (1024, 1024, 5), (2048, 1024, 5),
                   (1024, 3072, 3), (3072, 1024, 5), (4096, 16384, 2),
                   (8192, 288, 8), (256, 8192, 1), (8192, 4096, 4)]


@pytest.mark.parametrize("K,N,split", QMM_CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_tolerance_covers_the_factored_scale(K, N, split,
                                                          dtype):
    """y = s (x @ q) in float32, the card's order, against the plain
    version's x @ (q s): `quant_matmul_tolerance` holds at every decode
    shape, K up to 8192, with the scale applied once per column."""
    r = np.random.default_rng(K + N)
    x = torch.from_numpy(r.normal(size=(8, K)).astype(np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    q = torch.from_numpy(r.integers(-127, 128, (K, N)).astype(np.int8))
    s = torch.from_numpy(((r.random(N) + 0.1) * 0.01).astype(np.float32))
    ref = TQM.quant_matmul_ref(x, q, s)
    tol = TQM.quant_matmul_tolerance(x, q, s, ref)
    for chunks in (1, split):
        got = _factored(x, q, s, chunks)
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= tol).all()), float((diff / tol).max())


def test_flash_attention_takes_every_served_head_dim():
    """Fault F3 (repaired): every architecture whose layers the port serves
    with attention has its head_dim among the kernel's (nemotron-4-340b's
    192 among them), so no served prefill raises on the card. Every
    architecture is served; MLA's K5 head_dim is qk_nope + qk_rope (v is
    padded to it), which deepseek-v2's config states as its head_dim."""
    from repro_torch.kernels.flash_attention import ops as TFAO
    served = {}
    for name, cfg in ARCHS.items():
        if cfg.mla is not None:
            assert cfg.resolved_head_dim == (cfg.mla.qk_nope_head_dim
                                             + cfg.mla.qk_rope_head_dim)
        if any(spec.mixer in ("attn", "local", "cross")
               for spec in cfg.layer_specs()):
            served[name] = cfg.resolved_head_dim
    assert served["nemotron-4-340b"] == 192 and "qwen3-0.6b" in served
    assert served["deepseek-v2-236b"] == 192 and "whisper-base" in served
    for name, hd in served.items():
        assert hd in TFAO.HEAD_DIMS, (name, hd)
        assert hd in TFAO.WGMMA_HEAD_DIMS, (name, hd)
