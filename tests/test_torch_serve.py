"""The port's serving path (`repro_torch.serve`, `repro_torch.train`)
against the JAX package's: quantized weights bit for bit, greedy tokens of
the quantized and dense steps and of the serving engine exactly, and the
samplers' distributions (the two frameworks' random bits differ). Weights
are the JAX package's ``init`` carried across as numpy; everything runs at
``dtype="float32"``, where the JAX quantized step (dequantize to the
config's dtype, then the model) and the port's (K2 dequantizes in float32)
compute the same products."""
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
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro.serve import sampling as RS  # noqa: E402
from repro.train import train_state as RTS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402
from repro_torch.serve import sampling as TS  # noqa: E402
from repro_torch.train import train_state as TTS  # noqa: E402

# head_dim 64 and d_model 256 make every attention and MLP weight large
# enough to quantize (last dim >= 64, >= 2^16 elements stacked), so all 7
# products of a layer go through K2's wrapper
QUANT_CFG = dict(vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, d_ff=512)


def carried(name="qwen3-0.6b", **overrides):
    rcfg = RARCHS[name].reduced(**overrides)
    tcfg = ARCHS[name].reduced(**overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _payload_values(q, shape, bits):
    """A payload's integer values: int8 at 8 bits; at 4 bits uint8 packed
    two to a byte along the last axis (ceil(N/2) bytes), unpacked."""
    if bits == 8:
        assert q.dtype == np.int8
        return q
    assert q.dtype == np.uint8
    assert q.shape == tuple(shape[:-1]) + ((shape[-1] + 1) // 2,)
    return TL.unpack_int4(torch.from_numpy(q), shape[-1]).numpy()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bit_exact(bits):
    _, _, rparams, tparams = carried(**QUANT_CFG)
    want = _with_paths(RQ.quantize_params(rparams, bits=bits))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams,
                                                            bits=bits)))
    assert got.keys() == want.keys()
    n_q = 0
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("['q']"):
            n_q += 1
            vals = _payload_values(got[k], w.shape, bits)
            np.testing.assert_array_equal(vals, w.astype(np.int8))
            assert np.abs(vals).max() <= 2 ** (bits - 1) - 1
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w)
    # embed table + wq, wk, wv, wo + wi_gate, wi_up, wo
    assert n_q == 8


def test_dequantize_and_abstract_quantized():
    _, _, rparams, tparams = carried(**QUANT_CFG)
    for bits in (8, 4):
        tq = TQ.quantize_params(tparams, bits=bits)
        want = RQ.dequantize_params(RQ.quantize_params(rparams, bits=bits),
                                    jnp.float32)
        got = TT.params_to_numpy(TQ.dequantize_params(tq, torch.float32))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)
        meta = jax.tree_util.tree_map(lambda t: t.to("meta"), tparams)
        shapes = TQ.abstract_quantized(meta, bits=bits)
        for a, b in zip(jax.tree_util.tree_leaves(shapes),
                        jax.tree_util.tree_leaves(tq)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.device.type == "meta"


def _spy_k2(monkeypatch):
    calls = []
    real = TL.quant_matmul

    def spy(x, w, s):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, s)

    monkeypatch.setattr(TL, "quant_matmul", spy)
    return calls


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_serve_step_tokens_equal(bits, monkeypatch):
    rcfg, tcfg, rparams, tparams = carried(**QUANT_CFG)
    calls = _spy_k2(monkeypatch)
    rq = RQ.quantize_params(rparams, bits=bits)
    tq = TQ.quantize_params(tparams, bits=bits)
    rstep = jax.jit(RQ.make_quant_serve_step(
        dataclasses.replace(rcfg, dtype="float32")))
    tstep = TQ.make_quant_serve_step(tcfg)
    B, prompt, new = 2, 5, 6
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, prompt)).astype(np.int32)
    rs = RT.init_decode_state(rcfg, B, 16, jnp.float32)
    ts = TT.init_decode_state(tcfg, B, 16, torch.float32, device="cpu")
    reset_launches()
    r_out, t_out = [], []
    rn = tn = None
    for t in range(prompt + new):
        if t < prompt:
            rin = jnp.asarray(toks[:, t:t + 1])
            tin = torch.from_numpy(toks[:, t:t + 1]).long()
        else:
            rin, tin = rn, tn
        rn, rs = rstep(rq, rs, rin)
        tn, ts = tstep(tq, ts, tin)
        r_out.append(np.asarray(rn))
        t_out.append(tn.numpy())
    np.testing.assert_array_equal(np.concatenate(t_out, 1),
                                  np.concatenate(r_out, 1))
    assert tn.dtype == torch.int32 and tn.shape == (B, 1)
    # 7 products per layer per step, each through K2's wrapper; on CPU
    # tensors the wrapper runs its plain version and launches nothing
    assert len(calls) == 7 * tcfg.num_layers * (prompt + new)
    assert LAUNCHES["quant_matmul"] == 0


def test_quant_step_logits_match_float_reference():
    """The port's quantized decode logits equal the JAX package's at
    float32: same int8 payload and scales, products reordered (1e-4)."""
    rcfg, tcfg, rparams, tparams = carried(**QUANT_CFG)
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
    rstep = jax.jit(lambda p, s, t: RT.decode_step(
        RQ.dequantize_params(p, jnp.float32), s, t, rcfg))
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 4))
    rs = RT.init_decode_state(rcfg, 2, 8, jnp.float32)
    ts = TT.init_decode_state(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(4):
        want, rs = rstep(rq, rs, jnp.asarray(toks[:, t:t + 1]))
        got, ts = TT.decode_step(tq, ts, torch.from_numpy(
            toks[:, t:t + 1]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_serve_and_prefill_steps_match():
    rcfg, tcfg, rparams, tparams = carried()
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (3, 10))
    want = RTS.make_prefill_step(rcfg)(rparams,
                                       {"tokens": jnp.asarray(toks)})
    got = TTS.make_prefill_step(tcfg)(tparams,
                                      {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, rcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    rstep, tstep = RTS.make_serve_step(rcfg), TTS.make_serve_step(tcfg)
    rs = RT.init_decode_state(rcfg, 3, 16, jnp.float32)
    ts = TT.init_decode_state(tcfg, 3, 16, torch.float32, device="cpu")
    rn, tn = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for _ in range(8):
        rn, rs = rstep(rparams, rs, rn)
        tn, ts = tstep(tparams, ts, tn)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))


def _requests(mod, vocab):
    return [mod.Request(rid=i, prompt=[(5 * i + 1) % vocab, 2, (3 * i) % vocab
                                       ][:1 + i % 3],
                        max_new_tokens=3 + i % 4) for i in range(5)]


@pytest.mark.parametrize("batch", [2, 3])
def test_serve_engine_outputs_and_stats_equal(batch):
    rcfg, tcfg, rparams, tparams = carried(vocab_size=64)
    reng = RE.ServeEngine(rparams, rcfg, batch=batch, max_len=32)
    teng = TE.ServeEngine(tparams, tcfg, batch=batch, max_len=32,
                          device="cpu")
    rreq = reng.run(_requests(RE, rcfg.vocab_size))
    treq = teng.run(_requests(TE, tcfg.vocab_size))
    assert [r.output for r in treq] == [r.output for r in rreq]
    assert all(r.done for r in treq)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


def test_serve_engine_eos_matches():
    rcfg, tcfg, rparams, tparams = carried(vocab_size=64)
    probe = TE.ServeEngine(tparams, tcfg, batch=2, max_len=32,
                           device="cpu").run(
        [TE.Request(0, [3, 4], max_new_tokens=8)])[0]
    eos = probe.output[2]
    reng = RE.ServeEngine(rparams, rcfg, batch=2, max_len=32)
    teng = TE.ServeEngine(tparams, tcfg, batch=2, max_len=32, device="cpu")
    r = reng.run([RE.Request(0, [3, 4], max_new_tokens=8, eos_id=eos),
                  RE.Request(1, [5], max_new_tokens=8)])
    t = teng.run([TE.Request(0, [3, 4], max_new_tokens=8, eos_id=eos),
                  TE.Request(1, [5], max_new_tokens=8)])
    assert [x.output for x in t] == [x.output for x in r]
    assert len(t[0].output) <= 3
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


# ---------------------------------------------------------------------------
# sampling: distributions, not bits
# ---------------------------------------------------------------------------

N_DRAWS = 20000
# 4.5 standard errors of a frequency estimated from N_DRAWS draws, for each
# side against the exact distribution
FREQ_TOL = 4.5 * np.sqrt(0.25 / N_DRAWS)
LOGITS = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0, 1.5], np.float32)


def _freqs(samples) -> np.ndarray:
    return np.bincount(np.asarray(samples).reshape(-1),
                       minlength=len(LOGITS)) / N_DRAWS


def _softmax(z):
    e = np.exp(z - z[np.isfinite(z)].max())
    e[~np.isfinite(z)] = 0
    return e / e.sum()


SAMPLERS = {
    # name: (jax call, port call, expected distribution)
    "temperature": (lambda k, l: RS.temperature(k, l, 0.7),
                    lambda g, l: TS.temperature(g, l, 0.7),
                    _softmax(LOGITS / 0.7)),
    "top_k": (lambda k, l: RS.top_k(k, l, 3, 1.0),
              lambda g, l: TS.top_k(g, l, 3, 1.0),
              _softmax(np.where(LOGITS >= 1.0, LOGITS, -np.inf))),
    "top_p": (lambda k, l: RS.top_p(k, l, 0.6, 1.0),
              lambda g, l: TS.top_p(g, l, 0.6, 1.0),
              _softmax(np.where(LOGITS >= 1.5, LOGITS, -np.inf))),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampling_distributions_agree(name):
    jcall, tcall, expect = SAMPLERS[name]
    logits = np.tile(LOGITS, (N_DRAWS, 1))
    js = jcall(jax.random.PRNGKey(0), jnp.asarray(logits))
    ts = tcall(torch.Generator().manual_seed(0), torch.from_numpy(logits))
    assert ts.dtype == torch.int32 and ts.shape == (N_DRAWS,)
    fj, ft = _freqs(js), _freqs(ts.numpy())
    np.testing.assert_array_equal(ft > 0, expect > 0)
    assert np.abs(fj - expect).max() < FREQ_TOL
    assert np.abs(ft - expect).max() < FREQ_TOL


def test_greedy_and_zero_temperature():
    logits = np.random.default_rng(0).normal(size=(4, 3, 11)).astype(
        np.float32)
    want = np.asarray(RS.greedy(jnp.asarray(logits)))
    got = TS.greedy(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TS.temperature(torch.Generator(), torch.from_numpy(logits),
                       0.0).numpy(), want)
