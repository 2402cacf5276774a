"""The port's Multi-head Latent Attention (`repro_torch.nn.attention.mla_*`)
and deepseek-v2 against the JAX package's: deepseek-v2-236b reduced (MLA
with its own small ranks, a dense layer then MoE layers of 4 experts, top
2, with shared experts), float32, the JAX package's ``init`` carried
across as numpy.

Tolerances: the MLA layer's output and its compressed caches within 1e-5
(float32 products of a few dozen terms, reordered); logits within 1e-4
absolute plus 1e-4 relative and the aux within 1e-6 relative (as
tests/test_torch_moe.py); the decode's logits against the last position of
a prefill over the same tokens within the same 1e-4 (the absorbed form
against k and v rebuilt per head, both float32); the w8 payloads bit for
bit and the w8 decode's logits within 1e-4 (as tests/test_torch_serve.py);
the engine's tokens and stats equal."""
import dataclasses

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs.base import MLAConfig as RMLAConfig  # noqa: E402
from repro.nn import attention as RA  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402

NAME = "deepseek-v2-236b"
ATOL = RTOL = 1e-4
LAYER_TOL = 1e-5
# d_model 512, 8 heads, ranks of 128 and head dims of 64: every MLA
# product quantizes (w_kr, 512 x 64, in the stacked MoE segment of 2
# repeats), and so do w_uk and w_uv (128 x 8 x 64), which no K2 product
# consumes
QUANT_MLA = dict(q_lora_rank=128, kv_lora_rank=128, qk_nope_head_dim=64,
                 qk_rope_head_dim=64, v_head_dim=64)
QUANT = dict(vocab_size=512, d_model=512, num_heads=8, num_kv_heads=8,
             head_dim=128, d_ff=256)


def _configs(mla=None, moe=None, **overrides):
    rcfg = RARCHS[NAME].reduced(**overrides)
    tcfg = ARCHS[NAME].reduced(**overrides)
    if mla:
        rcfg = dataclasses.replace(rcfg, mla=RMLAConfig(**mla))
        tcfg = dataclasses.replace(tcfg, mla=MLAConfig(**mla))
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return rcfg, tcfg


def carried(mla=None, moe=None, **overrides):
    rcfg, tcfg = _configs(mla, moe, **overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _layer(rparams, tparams):
    """The MLA parameters of the first layer in each package."""
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["segments"][0][0]["mixer"])
    return rp, TT._take(tparams["segments"][0][0]["mixer"], 0)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(TT.params_to_numpy(got)),
                               np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def test_mla_leaves_and_shapes_match():
    _, tcfg, rparams, tparams = carried()
    tp = TT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(rparams)}
    got = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
           jax.tree_util.tree_leaves_with_path(TT.params_to_numpy(tp))}
    assert got == want
    assert set(tparams["segments"][0][0]["mixer"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
        "w_kr", "wo"}


@pytest.mark.parametrize("case", ["prefill", "decode", "prompt_with_cache"])
def test_mla_layer_matches_reference(case):
    """No cache (k and v rebuilt per head, through K5's plain version with
    v padded); one token over a cache holding 5; a prompt of 4 tokens
    written into an empty cache under the causal mask. The output and the
    compressed caches (c_kv, k_rope)."""
    rcfg, tcfg, rparams, tparams = carried()
    rp, tp = _layer(rparams, tparams)
    r = np.random.default_rng(7)
    T = {"prefill": 9, "decode": 1, "prompt_with_cache": 4}[case]
    x = r.normal(size=(2, T, rcfg.d_model)).astype(np.float32)
    if case == "prefill":
        want, wc = RA.mla_apply(rp, jnp.asarray(x), rcfg)
        got, gc = TA.mla_apply(tp, torch.from_numpy(x), tcfg)
        assert wc is None and gc is None
    else:
        kv_len = 5 if case == "decode" else 0
        rc = RA.make_mla_cache(rcfg, 2, 12, jnp.float32)
        tc = TA.make_mla_cache(tcfg, 2, 12, "float32", device="cpu")
        if kv_len:
            fill = {k: r.normal(size=a.shape).astype(np.float32) * 0.5
                    for k, a in rc.items()}
            fill = {k: np.where(np.arange(12)[None, :, None] < kv_len, a, 0)
                    .astype(np.float32) for k, a in fill.items()}
            rc = {k: jnp.asarray(a) for k, a in fill.items()}
            tc = {k: torch.from_numpy(a.copy()) for k, a in fill.items()}
        want, wc = RA.mla_apply(rp, jnp.asarray(x), rcfg, cache=rc,
                                kv_len=kv_len)
        got, gc = TA.mla_apply(tp, torch.from_numpy(x), tcfg, cache=tc,
                               kv_len=kv_len)
        assert gc is tc        # written in place
        for k in ("c_kv", "k_rope"):
            _close(gc[k], wc[k], LAYER_TOL)
    assert got.shape == x.shape
    _close(got, want, LAYER_TOL)


def test_attend_pads_v_to_q_head_dim_for_k5(monkeypatch):
    """v's head_dim smaller than q's: K5 (here its plain version) gets v
    padded with zero columns to q's head_dim, the output comes back at v's,
    equal to the JAX package's attend, whose scale is q's 1/sqrt(hd)."""
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape), kw))
        assert bool((v[..., 16:] == 0).all())
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    r = np.random.default_rng(3)
    q, k = (r.normal(size=(2, 11, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = r.normal(size=(2, 11, 4, 16)).astype(np.float32)
    got = TA.attend(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = RA.attend(*map(jnp.asarray, (q, k, v)), causal=True)
    assert calls == [((2, 11, 4, 24), (2, 11, 4, 24),
                      {"causal": True, "window": 0, "softcap": 0.0})]
    assert got.shape == (2, 11, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


def test_prefill_routes_each_mla_layer_through_k5(monkeypatch):
    """Every layer's prefill attention is one K5 call, causal, q and k at
    qk_nope + qk_rope, v padded to it; the decode makes none."""
    _, tcfg, _, tparams = carried()
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    tok = torch.from_numpy(tokens(2, 8, tcfg.vocab_size, seed=1)).long()
    TT.forward(tparams, {"tokens": tok}, tcfg)
    m = tcfg.mla
    hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert calls == [(hd, hd, hd, True)] * tcfg.num_layers
    calls.clear()
    state = TT.init_decode_state(tcfg, 2, 8, torch.float32, device="cpu")
    TT.decode_step(tparams, state, tok[:, :1], tcfg)
    assert calls == []


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_logits_and_aux_match():
    rcfg, tcfg, rparams, tparams = carried()
    tok = tokens(2, 20, rcfg.vocab_size, seed=2)
    want, waux = RT.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got, aux = TT.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                          tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_decode_steps_match_logits_and_caches():
    """A prompt of 3 tokens in one step (T > 1 into the cache), then one
    token a step; logits and every layer's compressed cache."""
    rcfg, tcfg, rparams, tparams = carried()
    B, steps = 3, 6
    tok = tokens(B, steps + 2, rcfg.vocab_size, seed=3)
    rstate = RT.init_decode_state(rcfg, B, 10, jnp.float32)
    tstate = TT.init_decode_state(tcfg, B, 10, "float32", device="cpu")
    rstep = jax.jit(lambda p, s, t: RT.decode_step(p, s, t, rcfg))
    chunks = [(0, 3)] + [(t, t + 1) for t in range(3, steps + 2)]
    for a, b in chunks:
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, a:b]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, a:b]).long(), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert tstate["kv_len"] == int(rstate["kv_len"]) == steps + 2
    for rc, tc in zip(rstate["caches"], tstate["caches"]):
        for k in ("c_kv", "k_rope"):
            _close(tc[0][k], rc[0][k], LAYER_TOL)


def test_decode_matches_the_last_position_of_a_prefill():
    """The absorbed decode over the compressed cache against the prefill
    (k and v rebuilt per head, K5's plain version with v padded) over the
    same tokens, at every position. Capacity factor 4 (= E) leaves every
    expert room for every token, so the prefill's routing drops none and
    each token's MoE output is its own, as at decode."""
    _, tcfg, _, tparams = carried(moe=dict(capacity_factor=4.0))
    tok = torch.from_numpy(tokens(2, 7, tcfg.vocab_size, seed=4)).long()
    full, _ = TT.forward(tparams, {"tokens": tok}, tcfg)
    state = TT.init_decode_state(tcfg, 2, 8, "float32", device="cpu")
    for t in range(7):
        got, state = TT.decode_step(tparams, state, tok[:, t:t + 1], tcfg)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_cache_refuses_positions_past_its_end():
    _, tcfg, _, tparams = carried()
    state = TT.init_decode_state(tcfg, 1, 4, "float32", device="cpu")
    state["kv_len"] = 3
    with pytest.raises(ValueError, match="cannot take 3 \\+ 2"):
        TT.decode_step(tparams, state, torch.zeros((1, 2), dtype=torch.long),
                       tcfg)


def _meta_init(cfg):
    """The port's own ``init`` at full width with every drawn leaf a meta
    tensor (norm scales and gates are made for real: they are small)."""
    real = TL.trunc_normal

    def meta(generator, shape, std, dtype, device=None, *, lead=()):
        return torch.empty(tuple(lead) + tuple(shape),
                           dtype=TL.torch_dtype(dtype), device="meta")

    TL.trunc_normal = meta
    try:
        return TT.init(torch.Generator(), cfg, device="cpu")
    finally:
        TL.trunc_normal = real


def test_full_config_param_count():
    """deepseek-v2-236b at full width and depth, counted on meta tensors:
    the JAX package's count to the parameter, inside its own range
    (tests/test_archs_smoke.py), and its active count (top 6 of 160)."""
    cfg = ARCHS[NAME]
    shapes = jax.eval_shape(lambda k: RT.init(k, RARCHS[NAME]),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    meta = _meta_init(cfg)
    n = TT.param_count(meta)
    assert n == want and 225e9 <= n <= 248e9
    assert TT.active_param_count(meta, cfg) == RT.active_param_count(
        shapes, RARCHS[NAME])


# ---------------------------------------------------------------------------
# w8 serving, the engine, the launcher
# ---------------------------------------------------------------------------


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_w8_payload_bit_equal():
    """MLA's leaves quantize as the JAX package's, bit for bit: w_uk and
    w_uv (kv_lora, H, head_dim), w_kr in the stacked MoE segment."""
    _, _, rparams, tparams = carried(QUANT_MLA, **QUANT)
    want = _with_paths(RQ.quantize_params(rparams, bits=8))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams, bits=8)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == (np.int8 if k.endswith("['q']") else w.dtype)
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype))
    for seg in (0, 1):
        for leaf in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"):
            assert (f"['segments'][{seg}][0]['mixer']['{leaf}']['kernel']"
                    "['q']") in got
    assert "['segments'][1][0]['mixer']['w_kr']['kernel']['q']" in got


def test_w8_decode_logits_match():
    rcfg, tcfg, rparams, tparams = carried(QUANT_MLA, **QUANT)
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
    assert TL.is_qleaf(TT._take(tq["segments"][0][0]["mixer"], 0)["w_uk"]
                       ["kernel"])
    rstep = jax.jit(lambda p, s, t: RT.decode_step(
        RQ.dequantize_params(p, jnp.float32), s, t, rcfg))
    tok = tokens(3, 5, rcfg.vocab_size, seed=6)
    rs = RT.init_decode_state(rcfg, 3, 8, jnp.float32)
    ts = TT.init_decode_state(tcfg, 3, 8, torch.float32, device="cpu")
    for t in range(5):
        want, rs = rstep(rq, rs, jnp.asarray(tok[:, t:t + 1]))
        got, ts = TT.decode_step(tq, ts, torch.from_numpy(tok[:, t:t + 1]),
                                 tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_serve_engine_outputs_equal():
    rcfg, tcfg, rparams, tparams = carried(vocab_size=64)
    reqs = [(i, [(5 * i + 1) % 64, 2, (3 * i) % 64][:1 + i % 3], 3 + i % 4)
            for i in range(5)]
    reng = RE.ServeEngine(rparams, rcfg, batch=2, max_len=16)
    teng = TE.ServeEngine(tparams, tcfg, batch=2, max_len=16, device="cpu")
    r = reng.run([RE.Request(i, p, max_new_tokens=n) for i, p, n in reqs])
    t = teng.run([TE.Request(i, p, max_new_tokens=n) for i, p, n in reqs])
    assert [x.output for x in t] == [x.output for x in r]
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


def test_launch_serve_on_the_cpu():
    out = launch_serve.main(["--arch", NAME, "--device", "cpu",
                             "--requests", "3", "--max-new-tokens", "4"])
    assert out["device"] == "cpu" and out["tokens"] == 12
