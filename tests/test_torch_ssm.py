"""The port's Mamba-1 path against the JAX package's: K6's plain version
(`repro_torch.kernels.ssm_scan`) against the Pallas selective scan, run in
interpret mode as ``tests/test_ssm_kernel_and_sampling.py`` runs it, and
against its oracle `ssm_scan_ref`; the mixer (`nn.ssm.ssm_apply`) in its
three cases; and falcon-mamba-7b's reduced config end to end (forward,
decode with its caches, the prefill step, the serving engine). The same
numpy inputs, or the JAX package's ``init`` carried across as numpy, go to
both sides; everything model-level runs at ``dtype="float32"``.

Tolerances: the scan within `ssm_scan_tolerance` (the bound stated beside
the plain version: per-step roundings of both sides carried through the
contractive recurrence, plus one bf16 rounding of the output on each side
for bf16 inputs); the mixer's outputs and states within 1e-5 (float32, a
handful of reordered sums of at most a few hundred terms); logits within
1e-4 absolute plus 1e-4 relative (two layers and a vocab projection), as
``tests/test_torch_lm.py`` holds them; greedy tokens and engine outputs
exactly."""
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
from repro.kernels.ssm_scan import ssm_scan as jax_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as jax_scan_ref  # noqa: E402,E501
from repro.nn import ssm as RS  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import train_state as RTS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.nn import ssm as TS  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.train import train_state as TTS  # noqa: E402

NAME = "falcon-mamba-7b"
ATOL = RTOL = 1e-4          # logits
STATE_TOL = 1e-5            # mixer outputs and states
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def scan_inputs(B, T, d, N, seed):
    """float32 numpy inputs as the JAX package's kernel test draws them:
    dt = softplus(normal - 1), A = -exp(0.3 normal)."""
    r = np.random.default_rng(seed)
    f = np.float32
    u = r.normal(size=(B, T, d)).astype(f)
    dt = np.log1p(np.exp(r.normal(size=(B, T, d)) - 1.0)).astype(f)
    B_ = r.normal(size=(B, T, N)).astype(f)
    C_ = r.normal(size=(B, T, N)).astype(f)
    A = (-np.exp(0.3 * r.normal(size=(d, N)))).astype(f)
    D = r.normal(size=(d,)).astype(f)
    return u, dt, B_, C_, A, D


def both(arrays, dtype):
    """The same inputs as JAX arrays and torch tensors; u, B_ and C_ in
    ``dtype`` (both frameworks round to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    low = (0, 2, 3)
    j = [jnp.asarray(a).astype(jdt) if i in low else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(tdt) if i in low else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    return j, t


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# name: (B, T, d, N, Pallas block_d, block_t, dtype)
SCAN_CASES = {
    "aligned": (1, 16, 32, 4, 16, 4, "float32"),
    "ragged_t_19": (2, 19, 32, 4, 16, 8, "float32"),
    "ragged_d_40": (2, 24, 40, 8, 16, 4, "float32"),
    "state_16": (1, 20, 48, 16, 16, 4, "float32"),
    "bf16_u": (2, 16, 32, 4, 16, 4, "bfloat16"),
    # the state crosses 16 of the Pallas kernel's time blocks
    "across_time_blocks": (1, 64, 16, 4, 16, 4, "float32"),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_plain_matches_pallas_and_ref(case):
    B, T, d, N, bd, bt, dtype = SCAN_CASES[case]
    (ju, jdt, jb, jc, ja, jd), targs = both(scan_inputs(B, T, d, N, T + d),
                                            dtype)
    reset_launches()
    got = SS.ssm_scan(*targs)
    assert LAUNCHES["ssm_scan"] == 0          # CPU tensors: plain version
    assert got.dtype == targs[0].dtype and got.shape == (B, T, d)
    tol = SS.ssm_scan_tolerance(*targs, got).numpy()
    pallas = jax_scan(ju, jdt, jb, jc, ja, jd, block_d=bd, block_t=bt,
                      interpret=True)
    ref = jax_scan_ref(ju, jdt, jb, jc, ja, jd)
    for want in (pallas, ref):
        assert np.all(np.abs(f32(got) - f32(want)) <= tol)


def test_scan_state_carries_the_whole_sequence():
    """A perturbation of the first input reaches outputs 12 steps later, by
    the same amount in the port and in the Pallas kernel."""
    arrays = scan_inputs(1, 16, 16, 4, seed=5)
    pert = [a.copy() for a in arrays]
    pert[0][:, 0] += 10.0
    out = {}
    for key, arr in (("base", arrays), ("pert", pert)):
        (ju, jdt, jb, jc, ja, jd), targs = both(arr, "float32")
        out[key] = (SS.ssm_scan(*targs).numpy(),
                    np.asarray(jax_scan(ju, jdt, jb, jc, ja, jd, block_d=16,
                                        block_t=4, interpret=True)))
    dt_port = out["pert"][0][:, 12:] - out["base"][0][:, 12:]
    dt_jax = out["pert"][1][:, 12:] - out["base"][1][:, 12:]
    assert np.abs(dt_port).max() > 1e-6
    np.testing.assert_allclose(dt_port, dt_jax, rtol=1e-4, atol=1e-5)


def test_scan_checks_its_inputs():
    _, (u, dt, B_, C_, A, D) = both(scan_inputs(1, 4, 8, 4, 0), "float32")
    with pytest.raises(TypeError, match="float32"):
        SS.ssm_scan(u, dt.to(torch.bfloat16), B_, C_, A, D)
    with pytest.raises(TypeError, match="share"):
        SS.ssm_scan(u.to(torch.bfloat16), dt, B_, C_, A, D)
    with pytest.raises(ValueError, match="mismatch"):
        SS.ssm_scan(u, dt, B_, C_, A[:, :2], D)
    with pytest.raises(ValueError, match="takes"):
        SS.ssm_scan(u[0], dt, B_, C_, A, D)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def mixer_params():
    rcfg, tcfg = RARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    rp = RS.ssm_init(jax.random.PRNGKey(3), rcfg, jnp.float32)
    tp = TT.map_tree(lambda _, a: torch.from_numpy(np.array(a)),
                     jax.tree_util.tree_map(np.asarray, rp))
    return rcfg, tcfg, rp, tp


def mixer_cache(tcfg, B, seed, *, zero_h=False):
    """A numpy cache with a random conv window and state."""
    s, d_inner = tcfg.ssm, tcfg.ssm.expand * tcfg.d_model
    r = np.random.default_rng(seed)
    h = r.normal(size=(B, d_inner, s.d_state)).astype(np.float32)
    return {"conv": r.normal(size=(B, s.d_conv - 1, d_inner)).astype(
        np.float32), "h": np.zeros_like(h) if zero_h else h}


def run_mixer(rcfg, tcfg, rp, tp, x, cache):
    want, wc = RS.ssm_apply(rp, jnp.asarray(x), rcfg, cache=None if
                            cache is None else jax.tree_util.tree_map(
                                jnp.asarray, cache))
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    got, gc = TS.ssm_apply(tp, torch.from_numpy(x), tcfg, cache=tc)
    return want, wc, got, gc


@pytest.mark.parametrize("T,cached", [(10, False), (1, True), (7, True)])
def test_ssm_apply_matches(T, cached):
    """No cache (K6's wrapper), one-token decode, and several tokens with a
    cache (the plain scan with its last state). The JAX package starts the
    last case from a zero state (fault C3), so its cache's state is 0."""
    rcfg, tcfg, rp, tp = mixer_params()
    x = np.random.default_rng(T).normal(size=(2, T, tcfg.d_model)).astype(
        np.float32)
    cache = mixer_cache(tcfg, 2, seed=T, zero_h=T > 1) if cached else None
    want, wc, got, gc = run_mixer(rcfg, tcfg, rp, tp, x, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STATE_TOL,
                               atol=STATE_TOL)
    if cached:
        for k in ("conv", "h"):
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       rtol=STATE_TOL, atol=STATE_TOL)
    else:
        assert gc is None and wc is None


def test_multi_token_with_cache_continues_from_its_state():
    """Fault C3 repaired in the port: several tokens through a cache equal
    the same tokens fed one at a time from that cache's state."""
    _, tcfg, _, tp = mixer_params()
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 5, tcfg.d_model)).astype(np.float32))
    cache = mixer_cache(tcfg, 2, seed=9)
    whole = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    stepped = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    y_whole, _ = TS.ssm_apply(tp, x, tcfg, cache=whole)
    y_steps = torch.cat([TS.ssm_apply(tp, x[:, t:t + 1], tcfg,
                                      cache=stepped)[0] for t in range(5)], 1)
    torch.testing.assert_close(y_whole, y_steps, rtol=STATE_TOL,
                               atol=STATE_TOL)
    for k in ("conv", "h"):
        torch.testing.assert_close(whole[k], stepped[k], rtol=STATE_TOL,
                                   atol=STATE_TOL)


def test_only_the_cache_free_scan_goes_to_k6(monkeypatch):
    calls = []
    real = TS.ssm_scan

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(TS, "ssm_scan", spy)
    _, tcfg, _, tp = mixer_params()
    r = np.random.default_rng(0)
    for T, cached in ((6, False), (1, True), (4, True)):
        x = torch.from_numpy(r.normal(size=(2, T, tcfg.d_model)).astype(
            np.float32))
        cache = None if not cached else {
            k: torch.from_numpy(v) for k, v in mixer_cache(tcfg, 2, 0).items()}
        TS.ssm_apply(tp, x, tcfg, cache=cache)
    d_inner = tcfg.ssm.expand * tcfg.d_model
    assert calls == [(2, 6, d_inner)]


# ---------------------------------------------------------------------------
# falcon-mamba-7b, reduced, end to end
# ---------------------------------------------------------------------------


def carried(**overrides):
    rcfg = RARCHS[NAME].reduced(**overrides)
    tcfg = ARCHS[NAME].reduced(**overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu")


def tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def test_params_carry_and_port_init_has_the_reference_tree():
    rcfg, tcfg, rparams, tparams = carried()
    assert TT.param_count(tparams) == RT.param_count(rparams)
    back = TT.params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(rparams),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = TT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    desc = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), mine)
    assert desc == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), rparams)
    m = mine["segments"][0][0]["mixer"]
    assert torch.equal(m["A_log"][1, 5], torch.log(torch.arange(
        1.0, tcfg.ssm.d_state + 1)))
    dt = torch.nn.functional.softplus(m["dt_proj"]["bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6


def test_forward_and_prefill_step_match():
    rcfg, tcfg, rparams, tparams = carried()
    tok = tokens(2, 13, rcfg.vocab_size, seed=13)
    want, _ = RT.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got, aux = TT.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                          tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    last = TTS.make_prefill_step(tcfg)(tparams,
                                       {"tokens": torch.from_numpy(tok)})
    want_last = RTS.make_prefill_step(rcfg)(rparams,
                                            {"tokens": jnp.asarray(tok)})
    assert last.shape == (2, rcfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               rtol=RTOL, atol=ATOL)


def test_decode_steps_match_logits_and_caches():
    rcfg, tcfg, rparams, tparams = carried()
    B, steps = 2, 6
    tok = tokens(B, steps, rcfg.vocab_size, seed=7)
    rstate = RT.init_decode_state(rcfg, B, 16, jnp.float32)
    tstate = TT.init_decode_state(tcfg, B, 16, torch.float32, device="cpu")
    shapes = [(tuple(a.shape), str(a.dtype)) for a in
              jax.tree_util.tree_leaves(rstate["caches"])]
    assert shapes == [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in
                      jax.tree_util.tree_leaves(tstate["caches"])]
    rstep = jax.jit(lambda p, s, t: RT.decode_step(p, s, t, rcfg))
    for t in range(steps):
        want, rstate = rstep(rparams, rstate, jnp.asarray(tok[:, t:t + 1]))
        got, tstate = TT.decode_step(
            tparams, tstate, torch.from_numpy(tok[:, t:t + 1]).long(), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    for rc, tc in zip(jax.tree_util.tree_leaves(rstate["caches"]),
                      jax.tree_util.tree_leaves(
                          TT.params_to_numpy(tstate["caches"]))):
        np.testing.assert_allclose(tc, np.asarray(rc), rtol=STATE_TOL,
                                   atol=STATE_TOL)


@pytest.mark.parametrize("batch", [2, 3])
def test_serve_engine_outputs_and_stats_equal(batch):
    rcfg, tcfg, rparams, tparams = carried(vocab_size=64)

    def requests(mod):
        return [mod.Request(rid=i, prompt=[(5 * i + 1) % 64, 2, (3 * i) % 64
                                           ][:1 + i % 3],
                            max_new_tokens=3 + i % 4) for i in range(5)]

    reng = RE.ServeEngine(rparams, rcfg, batch=batch, max_len=32)
    teng = TE.ServeEngine(tparams, tcfg, batch=batch, max_len=32,
                          device="cpu")
    rreq, treq = reng.run(requests(RE)), teng.run(requests(TE))
    assert [r.output for r in treq] == [r.output for r in rreq]
    assert all(r.done for r in treq)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No CUDA device (forced, so the test means the same on every
    machine): each entry point of the family refuses unless it is given
    device="cpu"."""
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS[NAME].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_decode_state(cfg, 2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_ssm_cache(cfg, 2, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", NAME])
    out = launch_serve.main(["--arch", NAME, "--device", "cpu",
                             "--requests", "2", "--max-new-tokens", "3"])
    assert out["device"] == "cpu" and out["tokens"] == 6


# ---------------------------------------------------------------------------
# K6's order of sums, emulated on the CPU
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """float32 fma: the exact product and sum in float64, rounded once
    more to float32 (a double rounding, far inside the bound)."""
    return (a.double() * b.double() + c.double()).float()


def _ex2_ftz(x, ulps):
    """exp2 of float32 x, correctly rounded, then ``ulps`` units in the
    last place off, and subnormal results flushed to 0: the card's
    ex2.approx.ftz.f32, within 2 ulp (CUDA C++ Programming Guide: exp2f,
    and __expf's 2 + floor(|1.173 x|) ulp, which is ex2.approx on
    x log2 e)."""
    e = np.exp2(x.double().numpy()).astype(np.float32)
    e = e + ulps * np.spacing(e)
    e[e < np.finfo(np.float32).tiny] = 0.0
    return torch.from_numpy(e)


def emulate_k6(u, dt, B_, C_, A, D, ulps):
    """The card's kernel step by step in float32: A log2 e once a lane,
    e = ex2.approx.ftz(dt (A log2 e)), h = fma(e, h, (dt u) B), each of a
    channel's 4 lanes' partial sum of its MAX_STATE / 4 products by fma,
    the xor-shuffle tree over the lanes (offsets 1, 2), then
    fma(D, u, acc); slots past N hold A = B = C = 0."""
    Bsz, T, d = u.shape
    N, M = A.shape[1], SS.ops.MAX_STATE
    lanes = 4                    # a channel's lanes (csrc/ssm_scan.cu, kG)
    S = M // lanes
    pad = (0, M - N)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    a2 = torch.nn.functional.pad(A, pad) * log2e             # (d, M)
    bf = torch.nn.functional.pad(B_.float(), pad)            # (B, T, M)
    cf = torch.nn.functional.pad(C_.float(), pad)
    h = torch.zeros((Bsz, d, M), dtype=torch.float32)
    lane = torch.arange(lanes)
    ys = []
    for t in range(T):
        ut, dtt = u[:, t].float(), dt[:, t]
        dtu = dtt * ut
        e = _ex2_ftz(dtt[..., None] * a2[None], ulps)
        h = _fma(e, h, dtu[..., None] * bf[:, t, None, :])
        prod = h.reshape(Bsz, d, lanes, S)
        c = cf[:, t, None, :].reshape(Bsz, 1, lanes, S)
        acc = torch.zeros((Bsz, d, lanes), dtype=torch.float32)
        for q in range(S):
            acc = _fma(prod[..., q], c[..., q], acc)
        o = 1
        while o < lanes:
            acc = acc + acc[..., lane ^ o]
            o *= 2
        ys.append(_fma(D[None], ut, acc[..., 0]))
    return torch.stack(ys, dim=1).to(u.dtype)


# name: (B, T, d, N, dtype): the falcon-mamba-7b state, the states that
# the lanes split unevenly (1, 3, 5), a step of one and ragged chunks
EMULATION_CASES = {
    "state_16": (2, 70, 24, 16, "float32"),
    "state_16_bf16": (2, 70, 24, 16, "bfloat16"),
    "state_1": (1, 40, 16, 1, "float32"),
    "state_3": (2, 33, 12, 3, "bfloat16"),
    "state_5": (1, 65, 20, 5, "float32"),
    "state_5_bf16": (2, 37, 12, 5, "bfloat16"),
    "one_step": (2, 1, 16, 16, "float32"),
}


@pytest.mark.parametrize("ulps", (-2, 2))
@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_k6_order_of_sums_within_the_unchanged_tolerance(case, ulps):
    """K6's new order of roundings (per-lane partial sums, the shuffle
    tree, exp2 with its error pushed 2 ulp either way and subnormal results
    flushed to 0) stays inside
    `ssm_scan_tolerance` against the port's plain version and the JAX
    package's reference on the same inputs."""
    B, T, d, N, dtype = EMULATION_CASES[case]
    (ju, jdt, jb, jc, ja, jd), targs = both(scan_inputs(B, T, d, N, T + N),
                                            dtype)
    ref = SS.ssm_scan_ref(*targs)
    tol = SS.ssm_scan_tolerance(*targs, ref)
    jref = torch.from_numpy(np.array(f32(jax_scan_ref(ju, jdt, jb, jc, ja,
                                                      jd))))
    got = emulate_k6(*targs, ulps=ulps)
    assert got.dtype == targs[0].dtype and got.shape == (B, T, d)
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= tol).all()), float((diff / tol).max())
    assert bool(((got.float() - jref).abs() <= tol).all())
