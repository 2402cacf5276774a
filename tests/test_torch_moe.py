"""The port's Mixture-of-Experts FFN (`repro_torch.nn.moe`) and phi3.5-moe
against the JAX package's `repro.nn.moe`: phi3.5-moe-42b-a6.6b reduced (4
experts, top 2), float32, the JAX package's ``init`` carried across as
numpy, in both dispatch modes.

Tolerances: routing is integer and held bit for bit: the expert ids of
the top k, the capacity, and for every (token, choice) pair its token, its
buffer row and whether it was kept (the JAX package's slots are derived
from its own ``_route`` by its formula, in numpy). Should a float32
near-tie between two experts' probabilities flip a choice, the assertion
reports the gap. The MoE layer's output within 1e-5 and its aux within
1e-6 relative (float32 products of 64 terms, reordered); logits within
1e-4 absolute plus 1e-4 relative (as tests/test_torch_lm.py); the train
step's loss and gradient norm within 2e-4 relative (as
tests/test_torch_train.py); the w8 payloads bit for bit and the w8
decode's logits within 1e-4 (as tests/test_torch_serve.py)."""
import dataclasses
import math

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
from repro.nn import moe as RM  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import train_state as RTS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.nn import moe as TM  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_state as TTS  # noqa: E402

NAME = "phi3.5-moe-42b-a6.6b"
ATOL = RTOL = 1e-4
LAYER_TOL = 1e-5
DISPATCH = ["global", "per_sample"]


def _configs(moe=None, **overrides):
    rcfg = RARCHS[NAME].reduced(**overrides)
    tcfg = ARCHS[NAME].reduced(**overrides)
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return rcfg, tcfg


def carried(moe=None, **overrides):
    rcfg, tcfg = _configs(moe, **overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _layer(rparams, tparams):
    """The MoE parameters of the first layer in each package."""
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["segments"][0][0]["moe"])
    return rp, TT._take(tparams["segments"][0][0]["moe"], 0)


def _reference_slots(topi, E, C):
    """The JAX package's dispatch (`repro.nn.moe._moe_tokens`) on its own
    expert ids, in numpy: stable argsort, searchsorted, the overflow row."""
    S, k = topi.shape
    flat_e = topi.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    st = np.repeat(np.arange(S), k)[order]
    starts = np.searchsorted(se, np.arange(E))
    pos = np.arange(S * k) - starts[se]
    keep = pos < C
    return st, np.where(keep, se * C + pos, E * C), keep


def _near_tie_gap(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability of a
    token: how close a float32 difference is to flipping a choice."""
    s = np.sort(probs, axis=-1)[:, ::-1]
    return float(np.min(s[:, k - 1] - s[:, k])) if s.shape[1] > k else 1.0


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_routing_bit_equal(dispatch, capacity_factor):
    """Each routed block (all 80 tokens; or each row of 40) routes as the
    JAX package's: ids of the top 2, capacity, token, row and kept flag of
    every pair. Capacity factor 0.5 drops tokens, so the overflow row is
    taken."""
    rcfg, tcfg, rparams, tparams = carried(
        dict(capacity_factor=capacity_factor, dispatch=dispatch))
    rp, tp = _layer(rparams, tparams)
    x = np.random.default_rng(0).normal(size=(2, 40, rcfg.d_model)).astype(
        np.float32)
    blocks = [x.reshape(80, -1)] if dispatch == "global" else [x[0], x[1]]
    dropped = 0
    for xf in blocks:
        logits = jnp.asarray(xf) @ rp["router"]["kernel"]
        _, want_ids, want_aux = RM._route(logits, rcfg.moe)
        want_ids = np.asarray(want_ids)
        E, S = rcfg.moe.num_experts, xf.shape[0]
        C = max(1, int(math.ceil(S * rcfg.moe.top_k / E
                                 * rcfg.moe.capacity_factor)))
        st, slot, keep = _reference_slots(want_ids, E, C)
        got = TM.route_tokens(tp, torch.from_numpy(xf), tcfg)
        gap = _near_tie_gap(np.asarray(jax.nn.softmax(logits)),
                            rcfg.moe.top_k)
        assert np.array_equal(got["topi"].numpy(), want_ids), \
            f"expert ids differ; smallest top-k gap {gap:.3e}"
        assert got["C"] == C
        np.testing.assert_array_equal(got["st"].numpy(), st)
        np.testing.assert_array_equal(got["slot"].numpy(), slot)
        np.testing.assert_array_equal(got["keep"].numpy(), keep)
        np.testing.assert_allclose(float(got["aux"]), float(want_aux),
                                   rtol=1e-6)
        dropped += int((~keep).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


def test_top_k_ties_keep_the_lower_expert_first():
    """Exact ties: the stable sort orders them as lax.top_k does."""
    rcfg, tcfg = _configs()
    logits = np.array([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0],
                       [0.5, 0.0, 0.5, 0.5]], np.float32)
    ww, wi, wa = RM._route(jnp.asarray(logits), rcfg.moe)
    gw, gi, ga = TM._route(torch.from_numpy(logits), tcfg.moe)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    assert float(ga) == float(wa)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("variant", ["softmax", "sigmoid_shared"])
def test_moe_layer_matches_reference(dispatch, variant):
    """The layer's output and aux; the second variant scores by sigmoid
    and adds a shared expert (deepseek-style)."""
    moe = dict(dispatch=dispatch)
    if variant == "sigmoid_shared":
        moe.update(router_softmax=False, num_shared_experts=1, d_shared=64)
    rcfg, tcfg, rparams, tparams = carried(moe)
    rp, tp = _layer(rparams, tparams)
    assert ("shared" in tp) == (variant == "sigmoid_shared")
    x = np.random.default_rng(1).normal(size=(3, 24, rcfg.d_model)).astype(
        np.float32)
    want, waux = RM.moe_apply(rp, jnp.asarray(x), rcfg)
    got, aux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_forward_logits_and_aux_match(dispatch):
    rcfg, tcfg, rparams, tparams = carried(dict(dispatch=dispatch))
    tok = tokens(2, 20, rcfg.vocab_size, seed=2)
    want, waux = RT.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got, aux = TT.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                          tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # two MoE layers, each aux >= 1 (equality only for a uniform router)
    assert float(aux) > 2.0
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_decode_steps_match(dispatch):
    rcfg, tcfg, rparams, tparams = carried(dict(dispatch=dispatch))
    B, steps = 3, 6
    tok = tokens(B, steps, rcfg.vocab_size, seed=3)
    rstate = RT.init_decode_state(rcfg, B, 8, jnp.float32)
    tstate = TT.init_decode_state(tcfg, B, 8, "float32", device="cpu")
    rstep = jax.jit(lambda p, s, t: RT.decode_step(p, s, t, rcfg))
    for t in range(steps):
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, t:t + 1]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, t:t + 1]).long(), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("shared", [False, True])
def test_active_param_count_matches(shared):
    moe = dict(num_shared_experts=1, d_shared=64) if shared else None
    rcfg, tcfg, rparams, tparams = carried(moe)
    got = TT.active_param_count(tparams, tcfg)
    assert got == RT.active_param_count(rparams, rcfg)
    assert TT.param_count(tparams) == RT.param_count(rparams)
    assert got < TT.param_count(tparams)


def test_full_config_active_share():
    """phi3.5-moe at full width, counted on meta tensors: the JAX
    package's 41,872,527,360 parameters, 6,640,373,760 active (the 6.6 B
    of the model's name)."""
    cfg = ARCHS[NAME]
    meta = _meta_params(cfg)
    assert TT.param_count(meta) == 41872527360
    assert TT.active_param_count(meta, cfg) == 6640373760


def _meta_params(cfg):
    """The parameter tree's shapes at full width without drawing them."""
    d, E, de = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    R = cfg.segments[0].repeats

    def t(*shape):
        return torch.empty(shape, device="meta")

    block = {"norm1": {"scale": t(R, d)}, "norm2": {"scale": t(R, d)},
             "mixer": {"wq": {"kernel": t(R, d, H, hd)},
                       "wk": {"kernel": t(R, d, KV, hd)},
                       "wv": {"kernel": t(R, d, KV, hd)},
                       "wo": {"kernel": t(R, H, hd, d)}},
             "moe": {"router": {"kernel": t(R, d, E)},
                     "experts": {"wi_gate": t(R, E, d, de),
                                 "wi_up": t(R, E, d, de),
                                 "wo": t(R, E, de, d)}}}
    return {"embed": {"table": t(cfg.vocab_size, d)},
            "segments": ((block,),), "final_norm": {"scale": t(d)},
            "lm_head": {"kernel": t(d, cfg.vocab_size)}}


def test_train_step_loss_carries_the_aux():
    """One train step: the loss (next-token loss plus 0.01 aux) and the
    gradient norm through the router and the dispatch equal the
    reference's."""
    rcfg, tcfg = _configs()
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40, weight_decay=0.1)
    rstate = RTS.init_state(jax.random.PRNGKey(0), rcfg,
                            RO.AdamWConfig(**kw))
    tok = tokens(4, 16, rcfg.vocab_size, seed=5)
    _, rm = jax.jit(RTS.make_train_step(rcfg, RO.AdamWConfig(**kw)))(
        rstate, {"tokens": jnp.asarray(tok)})
    tstate = TTS.state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate),
                                  tcfg, device="cpu")
    _, tm = TTS.make_train_step(tcfg, TO.AdamWConfig(**kw))(
        tstate, {"tokens": torch.from_numpy(tok)})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]), rtol=2e-4)
    _, aux = TT.forward(tstate.params, {"tokens": torch.from_numpy(tok)},
                        tcfg)
    assert float(aux) > 0


# ---------------------------------------------------------------------------
# w8 serving, the engine, the launcher
# ---------------------------------------------------------------------------

# d_model 128 and d_expert 128: the stacked experts (2, 4, 128, 128) and
# every attention product quantize; the router's 4 columns do not
QUANT = dict(vocab_size=512, d_model=128, num_heads=4, num_kv_heads=2,
             head_dim=32)


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_w8_payload_bit_equal():
    """The expert stacks take one scale per last-axis column over the
    repeat, expert and input axes, bit for bit as the JAX package's."""
    _, _, rparams, tparams = carried(dict(d_expert=128), **QUANT)
    want = _with_paths(RQ.quantize_params(rparams, bits=8))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams, bits=8)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == (np.int8 if k.endswith("['q']") else w.dtype)
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype))
    for leaf in ("wi_gate", "wi_up", "wo"):
        key = f"['segments'][0][0]['moe']['experts']['{leaf}']['scale']"
        assert got[key].shape == (128,)
    assert "['segments'][0][0]['moe']['router']['kernel']" in got


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_w8_decode_logits_match(dispatch):
    rcfg, tcfg, rparams, tparams = carried(dict(d_expert=128,
                                                dispatch=dispatch), **QUANT)
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
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
