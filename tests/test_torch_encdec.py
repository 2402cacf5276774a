"""The port's encoder-decoder and vision models against the JAX package's:
whisper-base (a bidirectional encoder over stub frame embeddings with
learned positions, decoder "cross" blocks, learned token positions,
LayerNorm, GELU) and llama-3.2-vision-11b (a gated cross-attention block
every fifth layer over stub patch embeddings), reduced, float32, the JAX
package's ``init`` carried across as numpy.

Every ``cross_gate`` is set to 0.5 in both packages before the weights
cross: the JAX package's init leaves it 0, where tanh(0) = 0 drops the
whole cross sublayer and a parity test would pass with cross attention
broken. Frames and patches are drawn from a seed, not zeros.

Tolerances: the encoder's output, one cross-attention call and a layer's
caches within 1e-5 (float32 products of a few dozen terms, reordered);
logits within 1e-4 absolute plus 1e-4 relative (as tests/test_torch_lm.py);
the w8 payloads bit for bit and the w8 decode's logits within 1e-4 (as
tests/test_torch_serve.py); the engine's tokens and stats equal."""
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
from repro.configs.base import EncoderConfig as REncoderConfig  # noqa: E402
from repro.nn import attention as RA  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import EncoderConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402
from repro_torch.train.train_state import make_prefill_step  # noqa: E402

ATOL = RTOL = 1e-4
LAYER_TOL = 1e-5
GATE = 0.5
WHISPER, VISION = "whisper-base", "llama-3.2-vision-11b"
MODELS = [WHISPER, VISION]
# d_model 256 and head_dim 64: every product of both models quantizes, and
# so do whisper's position tables (256 positions, 256 frames) and the
# stacked cross projections
QUANT = dict(vocab_size=512, d_model=256, num_heads=4, head_dim=64,
             d_ff=256)
QUANT_WHISPER = dict(QUANT, num_kv_heads=4, max_position_embeddings=256)
QUANT_VISION = dict(QUANT, num_kv_heads=2)


def _configs(name, **overrides):
    rcfg = RARCHS[name].reduced(**overrides)
    tcfg = ARCHS[name].reduced(**overrides)
    return rcfg, tcfg


def _gated(params):
    """The JAX package's parameters with every cross_gate at GATE."""
    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        return jnp.full(a.shape, GATE, a.dtype) if "cross_gate" in keys \
            else a
    return jax.tree_util.tree_map_with_path(leaf, params)


def carried(name, encoder=None, **overrides):
    rcfg, tcfg = _configs(name, **overrides)
    if encoder:
        rcfg = dataclasses.replace(rcfg, encoder=REncoderConfig(**encoder))
        tcfg = dataclasses.replace(tcfg, encoder=EncoderConfig(**encoder))
    rparams = _gated(RT.init(jax.random.PRNGKey(0), rcfg))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def quant_carried(name):
    if name == WHISPER:
        return carried(name, encoder=dict(num_layers=2, num_frames=256),
                       **QUANT_WHISPER)
    return carried(name, **QUANT_VISION)


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def context(cfg, B, seed):
    """Seeded stub frames (whisper) or patches (vision) at d_model, and
    the batch key they go under."""
    n, key = ((cfg.encoder.num_frames, "frames") if cfg.encoder is not None
              else (cfg.vision.num_patches, "patches"))
    return key, np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)


def batches(cfg, tok, seed):
    key, ctx = context(cfg, tok.shape[0], seed)
    return ({"tokens": jnp.asarray(tok), key: jnp.asarray(ctx)},
            {"tokens": torch.from_numpy(tok).long(),
             key: torch.from_numpy(ctx)})


def enc_out(rcfg, rparams, tb):
    """The cross-attention context a decode reads, in numpy: the JAX
    package's encoder over the frames, or the patches as they are."""
    if rcfg.encoder is not None:
        return np.array(RT._encoder_forward(
            rparams["encoder"], jnp.asarray(tb["frames"].numpy()), rcfg))
    return tb["patches"].numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(TT.params_to_numpy(got)),
                               np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_leaves_and_shapes_match(name):
    """The port's init has the JAX package's tree: cross_gate (float32,
    one a repeat), norm_cross, c_wq/c_wk/c_wv/c_wo, and whisper's
    pos_embed and encoder subtree."""
    _, tcfg, rparams, _ = carried(name)
    tp = TT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")

    def shapes(tree):
        return {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                for p, a in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(TT.params_to_numpy(tp)) == shapes(rparams)
    assert ("pos_embed" in tp and "encoder" in tp) == (name == WHISPER)


def test_encoder_forward_matches():
    rcfg, tcfg, rparams, tparams = carried(WHISPER)
    _, frames = context(rcfg, 2, seed=1)
    want = RT._encoder_forward(rparams["encoder"], jnp.asarray(frames), rcfg)
    got = TT._encoder_forward(tparams["encoder"], torch.from_numpy(frames),
                              tcfg)
    assert got.shape == frames.shape
    _close(got, want, LAYER_TOL)


def test_bf16_encoder_casts_float32_frames():
    """A stated difference from the JAX package (ROADMAP §3): on a bf16
    model the port casts the frames to bf16 before adding positions, so the
    encoder runs in bf16 and K5 takes its bf16 body. The JAX package keeps
    the frames' dtype, so on float32 frames its encoder runs in float32
    with the bf16 weights promoted, and returns float32. The size of the
    difference on the reduced encoder: a relative L2 of 5.3e-3 (seeds 1-3),
    as large as the port's against the JAX package given the same frames in
    bf16 (5.0e-3-5.3e-3). Bound 2e-2, about 4x."""
    rcfg, tcfg, rparams, tparams = carried(WHISPER, dtype="bfloat16")
    _, frames = context(rcfg, 2, seed=1)
    want = np.asarray(RT._encoder_forward(rparams["encoder"],
                                          jnp.asarray(frames), rcfg))
    got = TT._encoder_forward(tparams["encoder"], torch.from_numpy(frames),
                              tcfg)
    assert want.dtype == np.float32 and got.dtype == torch.bfloat16
    diff = got.float().numpy() - want
    assert np.linalg.norm(diff) / np.linalg.norm(want) < 2e-2


@pytest.mark.parametrize("case", ["enc_out", "enc_cache"])
def test_ungated_cross_branch_of_attn_apply(case):
    """`attn_apply(mixer="cross")`, which the model never reaches (its
    block passes mixer="attn" and adds the gated sublayer itself): the
    self-attention plus an ungated cross attention over the context, or
    over its given projections."""
    rcfg, tcfg, rparams, tparams = carried(VISION)
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["segments"][0][3]["mixer"])
    tp = TT._take(tparams["segments"][0][3]["mixer"], 0)
    assert "c_wq" in tp
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 7, rcfg.d_model)).astype(np.float32)
    _, ctx = context(rcfg, 2, seed=6)
    if case == "enc_out":
        rkw, tkw = ({"enc_out": jnp.asarray(ctx)},
                    {"enc_out": torch.from_numpy(ctx)})
    else:
        kv = [r.normal(size=(2, 16, rcfg.num_kv_heads, 16)).astype(
            np.float32) for _ in range(2)]
        rkw = {"enc_cache": dict(zip("kv", map(jnp.asarray, kv)))}
        tkw = {"enc_cache": dict(zip("kv", map(torch.from_numpy, kv)))}
    want, _ = RA.attn_apply(rp, jnp.asarray(x), rcfg, mixer="cross", **rkw)
    got, _ = TA.attn_apply(tp, torch.from_numpy(x), tcfg, mixer="cross",
                           **tkw)
    _close(got, want, LAYER_TOL)
    alone, _ = TA.attn_apply(tp, torch.from_numpy(x), tcfg, mixer="attn")
    assert float((got - alone).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="enc_out"):
        TA.attn_apply(tp, torch.from_numpy(x), tcfg, mixer="cross")


@pytest.mark.parametrize("T", [1, 5])
def test_non_causal_attend_goes_through_k5(monkeypatch, T):
    """Cross attention (T queries over S keys, T = 1 at decode) goes
    through K5 non-causal and equals the JAX package's attend."""
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    r = np.random.default_rng(T)
    q = r.normal(size=(2, T, 4, 16)).astype(np.float32)
    k, v = (r.normal(size=(2, 13, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = TA.attend(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = RA.attend(*map(jnp.asarray, (q, k, v)), causal=False)
    assert calls == [{"causal": False, "window": 0, "softcap": 0.0}]
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_k5_launches_of_a_prefill_and_a_decode_step(monkeypatch, name):
    """A prefill: whisper's encoder layers non-causal (T = S = frames), its
    decoder's self-attention causal and cross attention non-causal over the
    frames; the vision model's layers causal, its cross layers non-causal
    over the patches. A decode step: only the cross attention, T = 1."""
    rcfg, tcfg, _, tparams = carried(name)
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", spy)
    tok = tokens(2, 6, rcfg.vocab_size, seed=1)
    _, tb = batches(tcfg, tok, seed=2)
    TT.forward(tparams, tb, tcfg)
    n_cross = sum(s.mixer == "cross" for s in tcfg.layer_specs())
    n_ctx = tb.get("frames", tb.get("patches")).shape[1]
    n_enc = tcfg.encoder.num_layers if name == WHISPER else 0
    assert sorted(calls) == sorted(
        [(n_ctx, n_ctx, False)] * n_enc
        + [(6, 6, True)] * tcfg.num_layers + [(6, n_ctx, False)] * n_cross)
    calls.clear()
    state = TT.init_decode_state(tcfg, 2, 8, "float32", device="cpu")
    TT.decode_step(tparams, state, tb["tokens"][:, :1], tcfg)
    assert calls == [(1, n_ctx, False)] * n_cross


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_match(name):
    """And the context matters: other frames or patches move the logits
    (the gates are open)."""
    rcfg, tcfg, rparams, tparams = carried(name)
    tok = tokens(2, 12, rcfg.vocab_size, seed=2)
    rb, tb = batches(rcfg, tok, seed=3)
    want, waux = RT.forward(rparams, rb, rcfg)
    got, aux = TT.forward(tparams, tb, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) == float(waux) == 0.0
    _, other = batches(rcfg, tok, seed=4)
    moved, _ = TT.forward(tparams, other, tcfg)
    assert float((moved - got).abs().max()) > 1e-3


@pytest.mark.parametrize("name", MODELS)
def test_prefill_step_takes_frames_and_patches(name):
    rcfg, tcfg, rparams, tparams = carried(name)
    tok = tokens(2, 9, rcfg.vocab_size, seed=5)
    _, tb = batches(rcfg, tok, seed=6)
    last = make_prefill_step(tcfg)(tparams, tb)
    full, _ = TT.forward(tparams, tb, tcfg, remat=False)
    assert torch.equal(last, full[:, -1])


@pytest.mark.parametrize("name", MODELS)
def test_decode_steps_match_logits_and_caches(name):
    """Several one-token steps with the context in the state (whisper:
    the encoder's output over seeded frames), against the JAX package's
    decode and against the last position of the port's own forward."""
    rcfg, tcfg, rparams, tparams = carried(name)
    B, steps = 3, 6
    tok = tokens(B, steps, rcfg.vocab_size, seed=3)
    rb, tb = batches(rcfg, tok, seed=4)
    ctx = enc_out(rcfg, rparams, tb)
    rstate = RT.init_decode_state(rcfg, B, 8, jnp.float32)
    tstate = TT.init_decode_state(tcfg, B, 8, "float32", device="cpu")
    assert tuple(tstate["enc_out"].shape) == rstate["enc_out"].shape
    rstate["enc_out"] = jnp.asarray(ctx)
    tstate["enc_out"] = torch.from_numpy(ctx)
    rstep = jax.jit(lambda p, s, t: RT.decode_step(p, s, t, rcfg))
    full, _ = TT.forward(tparams, tb, tcfg)
    for t in range(steps):
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, t:t + 1]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, t:t + 1]).long(), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=RTOL, atol=ATOL)
    for rc, tc in zip(rstate["caches"], tstate["caches"]):
        for i, c in enumerate(tc):
            for k in ("k", "v"):
                _close(c[k], rc[i][k], LAYER_TOL)


def test_learned_positions_clamp_at_the_table_end():
    """At decode the position rows start at min(offset, max_pos - T), as
    the JAX package slices them."""
    rcfg, tcfg, rparams, tparams = carried(WHISPER)
    tok = tokens(2, 3, rcfg.vocab_size, seed=8)
    for offset in (0, 5, 125, 126, 400):
        want = RT._embed_tokens(rparams, jnp.asarray(tok), rcfg,
                                offset=jnp.int32(offset))
        got = TT._embed_tokens(tparams, torch.from_numpy(tok).long(), tcfg,
                               offset=offset)
        _close(got, want, 0.0)


@pytest.mark.parametrize("name", MODELS)
def test_full_config_param_count(name):
    """Full width and depth, counted on meta tensors: the JAX package's
    count to the parameter, inside its own range (tests/test_archs_smoke.py:
    whisper-base with its 32768-row position table)."""
    real = TL.trunc_normal

    def meta(generator, shape, std, dtype, device=None, *, lead=()):
        return torch.empty(tuple(lead) + tuple(shape),
                           dtype=TL.torch_dtype(dtype), device="meta")

    TL.trunc_normal = meta
    try:
        params = TT.init(torch.Generator(), ARCHS[name], device="cpu")
    finally:
        TL.trunc_normal = real
    shapes = jax.eval_shape(lambda k: RT.init(k, RARCHS[name]),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    n = TT.param_count(params)
    lo, hi = {WHISPER: (0.05, 0.12), VISION: (9.5, 11.5)}[name]
    assert n == want and lo * 1e9 <= n <= hi * 1e9


# ---------------------------------------------------------------------------
# w8 serving, the engine, the launcher
# ---------------------------------------------------------------------------


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", MODELS)
def test_w8_payload_bit_equal(name):
    """Bit for bit as the JAX package's: the cross projections, whisper's
    position tables (decoder and encoder) and encoder; cross_gate stays
    float32."""
    _, _, rparams, tparams = quant_carried(name)
    want = _with_paths(RQ.quantize_params(rparams, bits=8))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams, bits=8)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == (np.int8 if k.endswith("['q']") else w.dtype)
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype))
    i = 0 if name == WHISPER else 3
    for leaf in ("c_wq", "c_wk", "c_wv", "c_wo"):
        assert (f"['segments'][0][{i}]['mixer']['{leaf}']['kernel']['q']"
                in got)
    assert got[f"['segments'][0][{i}]['cross_gate']"].dtype == np.float32
    if name == WHISPER:
        for key in ("['pos_embed']['table']['q']",
                    "['encoder']['pos_embed']['table']['q']",
                    "['encoder']['segments'][0][0]['mixer']['wq']['kernel']"
                    "['q']"):
            assert key in got


@pytest.mark.parametrize("name", MODELS)
def test_w8_decode_logits_match(name):
    rcfg, tcfg, rparams, tparams = quant_carried(name)
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
    rstep = jax.jit(lambda p, s, t: RT.decode_step(
        RQ.dequantize_params(p, jnp.float32), s, t, rcfg))
    tok = tokens(2, 5, rcfg.vocab_size, seed=6)
    _, tb = batches(rcfg, tok, seed=7)
    ctx = enc_out(rcfg, rparams, tb)
    rs = RT.init_decode_state(rcfg, 2, 8, jnp.float32)
    ts = TT.init_decode_state(tcfg, 2, 8, torch.float32, device="cpu")
    rs["enc_out"], ts["enc_out"] = jnp.asarray(ctx), torch.from_numpy(ctx)
    for t in range(5):
        want, rs = rstep(rq, rs, jnp.asarray(tok[:, t:t + 1]))
        got, ts = TT.decode_step(tq, ts, torch.from_numpy(tok[:, t:t + 1]),
                                 tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_serve_engine_outputs_equal(name):
    """Both engines over the same context, every wave reading it."""
    rcfg, tcfg, rparams, tparams = carried(name, vocab_size=64)
    reqs = [(i, [(5 * i + 1) % 64, 2, (3 * i) % 64][:1 + i % 3], 3 + i % 4)
            for i in range(5)]
    _, tb = batches(rcfg, tokens(2, 1, 64, seed=0), seed=9)
    ctx = enc_out(rcfg, rparams, tb)
    reng = RE.ServeEngine(rparams, rcfg, batch=2, max_len=16)
    teng = TE.ServeEngine(tparams, tcfg, batch=2, max_len=16, device="cpu")
    r = reng.run([RE.Request(i, p, max_new_tokens=n) for i, p, n in reqs],
                 enc_out=jnp.asarray(ctx))
    t = teng.run([TE.Request(i, p, max_new_tokens=n) for i, p, n in reqs],
                 enc_out=torch.from_numpy(ctx))
    assert [x.output for x in t] == [x.output for x in r]
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


@pytest.mark.parametrize("name", MODELS)
def test_launch_serve_on_the_cpu(name):
    out = launch_serve.main(["--arch", name, "--device", "cpu",
                             "--requests", "3", "--max-new-tokens", "4"])
    assert out["device"] == "cpu" and out["tokens"] == 12
