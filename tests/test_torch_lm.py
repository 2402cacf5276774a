"""The port's LM track (`repro_torch.nn`) against the JAX package's
`repro.nn.transformer`: the same parameters, made by the JAX package's
``init`` and carried across as numpy, and the same token ids go through
both. Everything runs at ``dtype="float32"`` on reduced configs, so the two
differ only in summation order and in their transcendental functions.

Tolerances: logits within 1e-4 absolute plus 1e-4 relative (float32
sums of up to a few hundred terms, reordered, over two layers and a vocab
projection); decode caches within 1e-5 (k and v are one projection, norm
and rotation away from the shared weights). The fp8 (e4m3) cache: a value
that lies within float32 rounding of the midpoint between two e4m3 numbers
may round to either, so caches agree within one e4m3 step (2^-3 of the
value, 2^-9 absolute below the normal range) on all but 1% of entries, and
logits within 2e-2 of their largest magnitude."""
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
from repro.nn import transformer as RT  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402

ATOL = RTOL = 1e-4

FORWARD_ARCHS = {
    # name: (reduced overrides, prompt length)
    "qwen3-0.6b": ({}, 12),
    # local/global alternation with T > window (the JAX package's banded
    # path), attention and logit softcaps, post-norms, GeGLU, embed scale
    "gemma2-2b": ({}, 40),
    "gemma-7b": ({}, 9),
    # squared ReLU, untied LM head
    "nemotron-4-340b": ({}, 10),
    # RG-LRU and local attention past the window (tests/test_torch_hybrid.py
    # holds the rest of the hybrid slice)
    "recurrentgemma-9b": ({}, 40),
}


def carried(name, **overrides):
    """A reduced float32 config in both packages and the JAX package's
    random weights in each."""
    rcfg = RARCHS[name].reduced(**overrides)
    tcfg = ARCHS[name].reduced(**overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(FORWARD_ARCHS))
def test_forward_logits_match(name):
    overrides, T = FORWARD_ARCHS[name]
    rcfg, tcfg, rparams, tparams = carried(name, **overrides)
    tok = tokens(2, T, rcfg.vocab_size, seed=T)
    want, _ = RT.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got, aux = TT.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                          tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_params_round_trip_and_count():
    rcfg, tcfg, rparams, tparams = carried("qwen3-0.6b")
    assert TT.param_count(tparams) == RT.param_count(rparams)
    back = TT.params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(rparams),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, rparams)) == \
        jax.tree_util.tree_structure(back)


def test_port_init_has_the_reference_shapes():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    mine = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = RT.init(jax.random.PRNGKey(0), RARCHS["qwen3-0.6b"].reduced())
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert got == want
    # truncated normal: every draw within 2 std of zero
    w = mine["segments"][0][0]["mixer"]["wq"]["kernel"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6


def _check_decode(name, cache_dtype, steps, max_len, seed):
    """``steps`` one-token decode steps in both packages: every step's
    logits, then every cache."""
    rcfg, tcfg, rparams, tparams = carried(name)
    B = 2
    tok = tokens(B, steps, rcfg.vocab_size, seed=seed)
    rstate = RT.init_decode_state(rcfg, B, max_len, jnp.dtype(cache_dtype))
    tstate = TT.init_decode_state(tcfg, B, max_len, cache_dtype,
                                  device="cpu")
    rstep = jax.jit(lambda p, s, t: RT.decode_step(p, s, t, rcfg))
    for t in range(steps):
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, t:t + 1]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, t:t + 1]).long(), tcfg)
        want = np.asarray(want)
        if cache_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)
        else:
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err < 2e-2, (t, err)
    assert tstate["kv_len"] == int(rstate["kv_len"]) == steps
    for rc, tc in zip(jax.tree_util.tree_leaves(rstate["caches"]),
                      jax.tree_util.tree_leaves(
                          TT.params_to_numpy(tstate["caches"]))):
        rc = np.asarray(rc, np.float32)
        assert rc.shape == tc.shape
        if cache_dtype == "float32":
            np.testing.assert_allclose(tc, rc, rtol=1e-5, atol=1e-5)
        else:
            step = np.maximum(np.abs(rc) * 2.0 ** -3, 2.0 ** -9)
            off = np.abs(tc - rc) > 0
            assert np.all(np.abs(tc - rc) <= step + 1e-12)
            assert off.mean() <= 0.01, off.mean()
    return tstate


@pytest.mark.parametrize("cache_dtype", ["float32", "float8_e4m3fn"])
def test_decode_steps_match_logits_and_caches(cache_dtype):
    _check_decode("qwen3-0.6b", cache_dtype, steps=6, max_len=16, seed=7)


@pytest.mark.parametrize("cache_dtype", ["float32", "float8_e4m3fn"])
def test_ring_decode_steps_match_logits_and_caches(cache_dtype):
    """gemma2-2b's local layers decode through a ring buffer of ``window``
    slots (16 reduced): 24 steps at max_len 32 wrap it once."""
    state = _check_decode("gemma2-2b", cache_dtype, steps=24, max_len=32,
                          seed=9)
    assert state["caches"][0][0]["k"].shape[2] == 16


def test_entry_points_raise_without_a_card(monkeypatch):
    """No CUDA device (forced, so the test means the same on every
    machine): each entry point refuses unless it is given device="cpu"."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["qwen3-0.6b"].reduced()
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init(g, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_decode_state(cfg, 2, 8, torch.float32)
    params = TT.init(g, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.params_from_numpy(TT.params_to_numpy(params), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, batch=2, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen3-0.6b"])
    out = launch_serve.main(["--arch", "qwen3-0.6b", "--device", "cpu",
                             "--requests", "2", "--max-new-tokens", "3"])
    assert out["device"] == "cpu" and out["tokens"] == 6


@pytest.mark.parametrize("name,what", [
    ("deepseek-v2-236b", "MLA"),
    ("whisper-base", "whisper"), ("llama-3.2-vision-11b", "vision")])
def test_later_slices_raise(name, what):
    with pytest.raises(NotImplementedError, match=what):
        TT.init(torch.Generator().manual_seed(0), ARCHS[name].reduced(),
                device="cpu")


def test_ssm_family_builds():
    """falcon-mamba-7b's "ssm" mixer was a later slice; the port now builds
    it (its parity tests are in tests/test_torch_ssm.py)."""
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert set(params["segments"][0][0]["mixer"]) >= {"in_proj", "A_log"}
    state = TT.init_decode_state(cfg, 1, 8, torch.float32, device="cpu")
    logits, _ = TT.decode_step(params, state,
                               torch.zeros((1, 1), dtype=torch.long), cfg)
    assert logits.shape == (1, 1, cfg.vocab_size)
