"""The port's sliding-window ring buffer, banded local attention and RG-LRU
block against the JAX package's: gemma2-2b (local/global alternation) and
recurrentgemma-9b (rec, rec, local) reduced, float32, with the JAX
package's ``init`` carried across as numpy.

Tolerances: logits within 1e-4 absolute plus 1e-4 relative (as
tests/test_torch_lm.py: float32 sums of a few hundred terms, reordered,
over a few layers and the vocab projection); the ring caches and the
RG-LRU states (``h``, ``conv``) within 1e-5 (one projection, norm,
rotation or float32 recurrence of a few dozen steps from the shared
weights); one RG-LRU layer's output and attention alone within 1e-5; the
w8 payloads bit for bit, and the w8 decode's logits within 1e-4, as
tests/test_torch_serve.py states (K2's plain version dequantizes in
float32, as the JAX step does at ``dtype="float32"``)."""
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
import torch.nn.functional as F  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.nn import attention as RA  # noqa: E402
from repro.nn import rglru as RR  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import RGLRUConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402,E501
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import rglru as TR  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402

ATOL = RTOL = 1e-4
STATE_TOL = 1e-5
HYBRIDS = ["gemma2-2b", "recurrentgemma-9b"]
# d_model and lru_width 256, head_dim 64: every dense product, RG-LRU's
# w_a and w_i (256 x 256) and the stacked conv kernels quantize
QUANT_CFG = dict(vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, d_ff=512)


def carried(name, **overrides):
    """A reduced float32 config in both packages and the JAX package's
    random weights in each (the reduced window is 16)."""
    rcfg = RARCHS[name].reduced(**overrides)
    tcfg = ARCHS[name].reduced(**overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def quant_overrides(name):
    if name == "recurrentgemma-9b":
        return dict(QUANT_CFG, rglru=RGLRUConfig(lru_width=256))
    return dict(QUANT_CFG)


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _decode_both(rcfg, tcfg, rparams, tparams, tok, max_len, *,
                 rprep=lambda p: p):
    """Step both packages through ``tok`` one token at a time; returns the
    logits of each step and the final states."""
    B, steps = tok.shape
    rstate = RT.init_decode_state(rcfg, B, max_len, jnp.float32)
    tstate = TT.init_decode_state(tcfg, B, max_len, "float32", device="cpu")
    rstep = jax.jit(lambda p, s, t: RT.decode_step(rprep(p), s, t, rcfg))
    out = []
    for t in range(steps):
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, t:t + 1]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, t:t + 1]).long(), tcfg)
        out.append((got.numpy(), np.asarray(want)))
    return out, rstate, tstate


def _assert_states(rstate, tstate):
    want = _leaves(rstate["caches"])
    got = _leaves(TT.params_to_numpy(tstate["caches"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=STATE_TOL, atol=STATE_TOL)


# ---------------------------------------------------------------------------
# banded local attention: the windowed yardstick of K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [16, 37, 48, 5])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_attend_local_banded_matches_reference(T, softcap):
    """T ragged to the window (37: a padded last block; 5: one block
    shorter than the window) and a multiple of it; GQA groups of 2; K5's
    plain version with the window computes the same function."""
    B, H, KV, hd, W = 2, 4, 2, 16, 16
    r = np.random.default_rng(T)
    q = r.normal(size=(B, T, H, hd)).astype(np.float32)
    k = r.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = r.normal(size=(B, T, KV, hd)).astype(np.float32)
    want = np.asarray(RA.attend_local_banded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W,
        softcap=softcap))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TA.attend_local_banded(tq, tk, tv, window=W, softcap=softcap)
    assert got.shape == (B, T, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=STATE_TOL,
                               atol=STATE_TOL)
    plain = flash_attention_plain(tq, tk, tv, causal=True, window=W,
                                  softcap=softcap)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=STATE_TOL,
                               atol=STATE_TOL)


# ---------------------------------------------------------------------------
# the models: forward, decode across ring wraps, max_len against window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", HYBRIDS)
@pytest.mark.parametrize("T", [40, 12])
def test_forward_logits_match(name, T):
    """T = 40 passes the window of 16 (the JAX package's banded path; K5's
    windowed plain version here), T = 12 does not."""
    rcfg, tcfg, rparams, tparams = carried(name)
    tok = tokens(2, T, rcfg.vocab_size, seed=T)
    want, waux = RT.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got, aux = TT.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                          tcfg)
    assert got.dtype == torch.float32 and float(aux) == float(waux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", HYBRIDS)
def test_decode_across_two_ring_wraps(name):
    """40 steps through a window of 16 (two wraps and a half) at max_len
    48: every step's logits, then the ring caches, the global caches and
    the RG-LRU states."""
    rcfg, tcfg, rparams, tparams = carried(name)
    tok = tokens(2, 40, rcfg.vocab_size, seed=11)
    out, rstate, tstate = _decode_both(rcfg, tcfg, rparams, tparams, tok, 48)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tstate["kv_len"] == int(rstate["kv_len"]) == 40
    _assert_states(rstate, tstate)
    local = [i for i, s in enumerate(tcfg.segments[0].pattern)
             if s.mixer == "local"][0]
    assert tstate["caches"][0][local]["k"].shape[2] == tcfg.window_size


@pytest.mark.parametrize("name", HYBRIDS)
@pytest.mark.parametrize("max_len", [8, 16, 24])
def test_max_len_against_window(name, max_len):
    """A local layer gets min(max_len, window) slots: below the window an
    ordinary cache read under the window's mask, at and past it the ring
    buffer. Steps up to max_len."""
    rcfg, tcfg, rparams, tparams = carried(name)
    tok = tokens(2, max_len, rcfg.vocab_size, seed=max_len)
    out, rstate, tstate = _decode_both(rcfg, tcfg, rparams, tparams, tok,
                                       max_len)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_states(rstate, tstate)
    for spec, c in zip(tcfg.segments[0].pattern, tstate["caches"][0]):
        if spec.mixer == "local":
            assert c["k"].shape[2] == min(max_len, tcfg.window_size)


def test_ring_refuses_several_tokens_a_step():
    """Fault C6: the JAX package's ring path is right for one token a step
    only; the port refuses several into a ring cache, and still takes them
    into an ordinary local cache (max_len below the window)."""
    _, tcfg, _, tparams = carried("gemma2-2b")
    tok = torch.zeros((1, 3), dtype=torch.long)
    ring = TT.init_decode_state(tcfg, 1, 32, "float32", device="cpu")
    with pytest.raises(ValueError, match="C6"):
        TT.decode_step(tparams, ring, tok, tcfg)
    plain = TT.init_decode_state(tcfg, 1, 8, "float32", device="cpu")
    logits, plain = TT.decode_step(tparams, plain, tok, tcfg)
    assert logits.shape == (1, 3, tcfg.vocab_size) and plain["kv_len"] == 3


def test_ring_decode_matches_the_windowed_forward():
    """Past the window, the port's ring decode gives the last-position
    logits of its own cache-free forward (K5's windowed plain version),
    as phases 28 and 29 of chip_smoke.py check on the card."""
    _, tcfg, _, tparams = carried("recurrentgemma-9b")
    tok = torch.from_numpy(tokens(2, 36, tcfg.vocab_size, seed=3)).long()
    state = TT.init_decode_state(tcfg, 2, 64, "float32", device="cpu")
    for t in range(36):
        logits, state = TT.decode_step(tparams, state, tok[:, t:t + 1], tcfg)
        if t in (17, 30, 35):
            want, _ = TT.forward(tparams, {"tokens": tok[:, :t + 1]}, tcfg)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       want[:, -1].numpy(), rtol=RTOL,
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# the RG-LRU layer alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["scan", "scan_from_cache", "one_step"])
def test_rglru_layer_matches_reference(case):
    """No cache (the prefill's scan), a cache and 7 tokens (the scan from
    the cache's h, which the JAX package also starts from), a cache and
    one token (one state update): output, h and the conv state."""
    rcfg, tcfg, rparams, tparams = carried("recurrentgemma-9b")
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["segments"][0][0][
        "mixer"])
    tp = TT._take(tparams["segments"][0][0]["mixer"], 0)
    r = np.random.default_rng(5)
    T = 1 if case == "one_step" else 7
    x = r.normal(size=(2, T, rcfg.d_model)).astype(np.float32)
    cache = None
    if case != "scan":
        w = tcfg.rglru.lru_width
        cache = {"conv": r.normal(size=(2, 3, w)).astype(np.float32),
                 "h": r.normal(size=(2, w)).astype(np.float32)}
    want, wc = RR.rglru_apply(rp, jnp.asarray(x), rcfg, cache=None
                              if cache is None else
                              jax.tree_util.tree_map(jnp.asarray, cache))
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    got, gc = TR.rglru_apply(tp, torch.from_numpy(x), tcfg, cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STATE_TOL, atol=STATE_TOL)
    if cache is None:
        assert gc is None and wc is None
    else:
        assert gc is tc                     # written in place
        for key in ("h", "conv"):
            np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                       rtol=STATE_TOL, atol=STATE_TOL)


def test_rglru_softplus_has_no_threshold():
    """jax.nn.softplus is log1p(exp(x)) everywhere; F.softplus switches to
    x above 20. The port's decay follows the JAX package at Lambda 30."""
    lam = np.array([-5.0, 0.0, 19.0, 21.0, 30.0], np.float32)
    r = np.full((1, 1, 5), 0.5, np.float32)
    want = -8.0 * r * np.asarray(jax.nn.softplus(jnp.asarray(lam)))
    got = TR._log_a(torch.from_numpy(r), torch.from_numpy(lam), 8.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert float(F.softplus(torch.tensor(30.0))) == 30.0


def test_rglru_init_shapes_and_decay_range():
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    mine = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = RT.init(jax.random.PRNGKey(0), RARCHS["recurrentgemma-9b"].reduced())
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                                 mine)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  ref)
    assert got == want
    a = torch.sigmoid(mine["segments"][0][0]["mixer"]["Lambda"])
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


@pytest.mark.parametrize("name", HYBRIDS)
def test_param_counts_match(name):
    rcfg, tcfg, rparams, tparams = carried(name)
    assert TT.param_count(tparams) == RT.param_count(rparams)
    assert TT.active_param_count(tparams, tcfg) == \
        RT.active_param_count(rparams, rcfg) == TT.param_count(tparams)


# ---------------------------------------------------------------------------
# w8 serving, the engine, the launcher
# ---------------------------------------------------------------------------


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", HYBRIDS)
def test_w8_payload_bit_equal(name):
    """Every quantizable leaf, RG-LRU's w_a and w_i and the stacked conv
    kernels among them, quantized bit for bit as the JAX package does."""
    _, _, rparams, tparams = carried(name, **quant_overrides(name))
    want = _with_paths(RQ.quantize_params(rparams, bits=8))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams, bits=8)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == (np.int8 if k.endswith("['q']") else w.dtype)
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype))
    if name == "recurrentgemma-9b":
        for leaf in ("w_a", "w_i"):
            assert f"['mixer']['{leaf}']['kernel']['q']" in "".join(got)


@pytest.mark.parametrize("name", HYBRIDS)
def test_w8_decode_logits_match(name):
    """The w8 decode through a ring wrap: the port's step on the int8
    payload (K2's plain version for the dense products, w_a and w_i
    dequantized through `layers.real`) against the JAX package's step on
    the dequantized tree."""
    rcfg, tcfg, rparams, tparams = carried(name, **quant_overrides(name))
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
    tok = tokens(2, 20, rcfg.vocab_size, seed=4)
    out, rstate, tstate = _decode_both(
        rcfg, tcfg, rq, tq, tok, 32,
        rprep=lambda p: RQ.dequantize_params(p, jnp.float32))
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_states(rstate, tstate)


@pytest.mark.parametrize("name", HYBRIDS)
def test_serve_engine_outputs_equal(name):
    """The engine through the ring buffer (max_len 32 > window 16, 17
    steps a wave) and the recurrent caches: outputs and stats equal."""
    rcfg, tcfg, rparams, tparams = carried(name, vocab_size=64)
    reqs = [(i, [(5 * i + 1) % 64, 2, (3 * i) % 64][:1 + i % 3], 9 + i % 6)
            for i in range(5)]
    reng = RE.ServeEngine(rparams, rcfg, batch=3, max_len=32)
    teng = TE.ServeEngine(tparams, tcfg, batch=3, max_len=32, device="cpu")
    r = reng.run([RE.Request(i, p, max_new_tokens=n) for i, p, n in reqs])
    t = teng.run([TE.Request(i, p, max_new_tokens=n) for i, p, n in reqs])
    assert [x.output for x in t] == [x.output for x in r]
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


@pytest.mark.parametrize("name", HYBRIDS)
def test_launch_serve_on_the_cpu(name):
    """The reduced config at the launcher's max_len 128, past the window:
    every wave decodes through the ring buffer."""
    out = launch_serve.main(["--arch", name, "--device", "cpu",
                             "--requests", "3", "--max-new-tokens", "20",
                             "--batch", "2"])
    assert out["device"] == "cpu" and out["tokens"] == 60
