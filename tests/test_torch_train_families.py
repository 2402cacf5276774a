"""The port's train step against the JAX package's for the families past
qwen3 and falcon-mamba: gemma2-2b (local and global attention, softcaps,
post-norms), recurrentgemma-9b (RG-LRU and local attention), phi3.5-moe
(routed experts), deepseek-v2 (MLA and a routed MoE with shared experts),
whisper-base (encoder and cross attention over frames) and
llama-3.2-vision (gated cross attention over patches), reduced, float32,
the reference's initial state carried across as numpy
(`train_state.state_from_numpy`); the donated update against the
functional one; the "dots" remat policy.

Sequences of 32 tokens cross the reduced window of 16. Frames and
patches are drawn from a seed, and every ``cross_gate`` is 0.5 in both
packages (at its init value 0, tanh(0) = 0 drops the cross sublayer and
its gradients).

Tolerances, as tests/test_torch_train.py states them: loss, grad_norm
and lr within 2e-4 relative a step; the parameters after n steps per
``_check_states`` (every one within 1e-5 + 2.2 n lr, all but 0.1% of each
leaf within 1e-5 + 1e-2 lr). The donated update and the "dots" policy are
held to the bit."""
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
from repro.data.tokens import TokenPipeline as RPipe  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as RPipeCfg  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import train_state as RTS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_state as TTS  # noqa: E402

CPU = torch.device("cpu")
SEQ, BATCH, GATE = 32, 4, 0.5
FAMILIES = ["gemma2-2b", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b",
            "deepseek-v2-236b", "whisper-base", "llama-3.2-vision-11b"]


def _rel_close(got, want, rtol):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


def _gated(tree):
    """The reference's tree with every cross_gate at GATE."""
    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        return jnp.full(a.shape, GATE, a.dtype) if "cross_gate" in keys \
            else a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _setup(name, **opt):
    rcfg, tcfg = RARCHS[name].reduced(), ARCHS[name].reduced()
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40, weight_decay=0.1)
    kw.update(opt)
    ropt = RO.AdamWConfig(**kw)
    rstate = RTS.init_state(jax.random.PRNGKey(0), rcfg, ropt)
    rstate = rstate._replace(params=_gated(rstate.params))
    return rcfg, tcfg, ropt, TO.AdamWConfig(**kw), rstate


def _batches(cfg, steps):
    """Token batches of the reference's pipeline and, where the model
    takes them, seeded frames or patches: (numpy dicts)."""
    pipe = RPipe(RPipeCfg(vocab_size=cfg.vocab_size, seq_len=SEQ,
                          global_batch=BATCH, seed=0, branching=2))
    out = []
    for i in range(steps):
        b = {"tokens": pipe.batch_at(i)["tokens"]}
        r = np.random.default_rng(100 + i)
        if cfg.encoder is not None:
            b["frames"] = r.normal(size=(BATCH, cfg.encoder.num_frames,
                                         cfg.d_model)).astype(np.float32)
        if cfg.vision is not None:
            b["patches"] = r.normal(size=(BATCH, cfg.vision.num_patches,
                                          cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _check_states(tstate, rstate, lr, steps):
    for g, w in zip(TO.tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(rstate.params)):
        diff = np.abs(g.detach().numpy() - np.asarray(w))
        assert diff.max() <= 1e-5 + 2.2 * steps * lr
        assert np.mean(diff > 1e-5 + 1e-2 * lr) <= 1e-3
    assert int(tstate.opt.step) == int(rstate.opt.step) == steps


@pytest.mark.parametrize("name,remats", [
    ("gemma2-2b", (True, False)), ("recurrentgemma-9b", (True,)),
    ("phi3.5-moe-42b-a6.6b", (True, False)), ("deepseek-v2-236b", (True,)),
    ("whisper-base", (True,)), ("llama-3.2-vision-11b", (True,))])
def test_train_step_matches_the_reference(name, remats):
    """2 steps of the reference's jitted step (remat on) and of the port's
    donated step, once per remat setting, from the same state and
    batches: loss, grad_norm and lr each step, the parameters after."""
    rcfg, tcfg, ropt, topt, rstate0 = _setup(name)
    batches = _batches(rcfg, 2)
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt, remat=True))
    rstate, rms = rstate0, []
    for b in batches:
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        rms.append(rm)
    start = jax.tree_util.tree_map(np.asarray, rstate0)
    for remat in remats:
        tstep = TTS.make_train_step(tcfg, topt, remat=remat)
        tstate = TTS.state_from_numpy(start, tcfg, device=CPU)
        for b, rm in zip(batches, rms):
            tstate, tm = tstep(tstate, _torch_batch(b))
            for key in ("loss", "grad_norm", "lr"):
                _rel_close(tm[key], rm[key], 2e-4)
        _check_states(tstate, rstate, ropt.lr, len(batches))


@pytest.mark.parametrize("name", ["qwen3-0.6b"] + FAMILIES)
def test_donated_update_is_bit_equal_to_the_functional_one(name,
                                                           monkeypatch):
    """3 steps of the train step (donated) against 3 of the same step with
    the functional `adamw_update` in place of `adamw_update_` from the same
    state: the same metrics and the same bits in every parameter, m and v,
    written into the donated state's own tensors. The update walks slices
    of 1000 elements here, so a leaf takes several."""
    _, tcfg, _, topt, rstate0 = _setup(name, grad_clip=0.05)
    start = jax.tree_util.tree_map(np.asarray, rstate0)
    batches = [_torch_batch(b) for b in _batches(tcfg, 3)]
    step = TTS.make_train_step(tcfg, topt, remat=False)

    def fstep(state, batch):
        with monkeypatch.context() as m:
            m.setattr(TTS, "adamw_update_", TO.adamw_update)
            return step(state, batch)

    fstate = TTS.state_from_numpy(start, tcfg, device=CPU)
    dstate = TTS.state_from_numpy(start, tcfg, device=CPU)

    def storage(state):
        return [t.data_ptr() for t in TO.tree_leaves(
            (state.params, state.opt.m, state.opt.v))]

    fstate0 = fstate                    # alive, so no address is reused
    before, fbefore = storage(dstate), storage(fstate0)
    monkeypatch.setattr(TO, "UPDATE_CHUNK", 1000)
    for b in batches:
        fstate, fm = fstep(fstate, b)
        dstate, dm = step(dstate, b)
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(fm[key], dm[key]), key
    assert float(fm["grad_norm"]) > topt.grad_clip     # clipping on
    assert storage(dstate) == before
    assert not set(storage(fstate)) & set(fbefore)      # new trees
    for a, b in zip(TO.tree_leaves(dstate), TO.tree_leaves(fstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_donated_update_keeps_the_bits_of_bf16_leaves(monkeypatch):
    """bf16 parameters (the card's dtype) with float32 moments, leaves of
    several sizes around the slice length and a transposed (not
    contiguous) gradient: the donated update's bits equal the functional
    one's, weight decay on the 2-D leaves only."""
    r = np.random.default_rng(3)

    def tree(scale, dtype):
        return {"w": torch.from_numpy(scale * r.normal(size=(37, 29))
                                      .astype(np.float32)).to(dtype),
                "b": torch.from_numpy(scale * r.normal(size=(1001,))
                                      .astype(np.float32)).to(dtype),
                "s": (torch.from_numpy(scale * r.normal(size=(3, 400))
                                       .astype(np.float32)).to(dtype),)}

    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         grad_clip=0.5)
    monkeypatch.setattr(TO, "UPDATE_CHUNK", 256)
    params = tree(1.0, torch.bfloat16)
    opt = TO.adamw_init(params)
    donated = TO.tree_map(torch.clone, params), TO.AdamWState(
        opt.step.clone(), TO.tree_map(torch.clone, opt.m),
        TO.tree_map(torch.clone, opt.v))
    for _ in range(3):
        grads = tree(3.0, torch.bfloat16)
        grads["w"] = grads["w"].t().contiguous().t()
        assert not grads["w"].is_contiguous()
        params, opt, fm = TO.adamw_update(cfg, grads, opt, params)
        dp, dopt, dm = TO.adamw_update_(cfg, grads, donated[1], donated[0])
        donated = dp, dopt
        assert torch.equal(fm["grad_norm"], dm["grad_norm"])
    for a, b in zip(TO.tree_leaves((params, opt)), TO.tree_leaves(donated)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_dots_policy_keeps_the_batchless_products(name):
    """remat_policy="dots" gives the gradients of remat on and off to the
    bit. Its backward recomputes no product without a batch dimension: it
    dispatches as many ``aten.mm`` as the backward without remat (MLA's k
    and v up-projections among them, no ``aten.bmm`` of batch 1), and
    recomputes every batched product, as many ``aten.bmm`` as remat on."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = self.bmm = self.bmm1 = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.aten.mm.default:
                self.mm += 1
            elif func == torch.ops.aten.bmm.default:
                self.bmm += 1
                self.bmm1 += args[0].shape[0] == 1
            return func(*args, **(kwargs or {}))

    cfg = ARCHS[name].reduced()
    params = T.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    params = T.map_tree(lambda path, t: torch.full_like(t, GATE)
                        if "cross_gate" in path else t, params)
    batch = _torch_batch(_batches(cfg, 1)[0])
    dots = dataclasses.replace(cfg, remat_policy="dots")
    grads, counts = [], []
    for c, remat in ((cfg, True), (cfg, False), (dots, True)):
        leaves = [p.detach().requires_grad_(True)
                  for p in TO.tree_leaves(params)]
        logits, aux = T.forward(TO.tree_unflatten(params, leaves), batch, c,
                                remat=remat)
        count = Products()
        with count:
            grads.append(torch.autograd.grad(
                logits.square().mean() + aux, leaves, allow_unused=True))
        counts.append((count.mm, count.bmm, count.bmm1))
    for g in grads[1:]:
        for a, b in zip(grads[0], g):
            assert (a is None and b is None) or torch.equal(a, b)
    remat_on, remat_off, kept = counts
    assert remat_off[0] <= kept[0] < remat_on[0]
    if cfg.encoder is None:
        assert kept[0] == remat_off[0]
    else:
        # the encoder's layers remat with no policy, as in the reference:
        # they recompute their products, at most the 6 a layer makes
        assert kept[0] - remat_off[0] <= 6 * cfg.encoder.num_layers
    assert kept[1] == remat_on[1] and kept[2] == 0
