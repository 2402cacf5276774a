"""The port's LM training path against the JAX package's: the token
pipeline (bit for bit), the losses, the learning-rate schedules, AdamW, the
train step on qwen3-0.6b and falcon-mamba-7b reduced (loss, grad_norm and
parameters after 2 steps, remat, microbatching, the paper's compression),
and the port's trainer (resume, preemption) and launcher on the CPU. The
reference's initial state crosses as numpy (`train_state.state_from_numpy`),
so both sides start from the same parameters.

Tolerances: the losses and schedules 1e-6 relative (float32, the same
operations); AdamW 1e-6 (float32 elementwise updates of the same values);
the train steps 2e-4 relative on loss and grad_norm (float32 models of a
few layers, their sums in other orders). On the parameters after n steps:
Adam's update lr m^ / (sqrt(v^) + eps) has |m^| / sqrt(v^) <= 1.1 in the
first two steps whatever the gradient's size, so a gradient within
rounding of 0, whose sign the two sides may not share, can move a
parameter by up to 2.2 lr a step: every parameter within 1e-5 + 2.2 n lr,
and all but 0.1% of each leaf within 1e-5 + 1e-2 lr."""
import dataclasses
import json
import threading

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
from repro.launch.train import make_compression as r_make_compression  # noqa: E402,E501
from repro.train import losses as RL  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import train_state as RTS  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: E402,E501
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.train import losses as TL  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_state as TTS  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_close(got, want, rtol):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


# ---------------------------------------------------------------------------
# data, losses, schedules, AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,branching", [
    (64, 16, 4, 0, 2), (97, 12, 8, 3, 8), (70000, 9, 6, 5, 4)])
def test_token_pipeline_batches_bit_equal(vocab, seq, batch, seed, branching):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
              branching=branching)
    mine, ref = TokenPipeline(TokenPipelineConfig(**kw)), \
        RPipe(RPipeCfg(**kw))
    for step in (0, 1, 2, 7, 123):
        a, b = mine.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for host in (0, 1):
            a = mine.batch_at(step, host_id=host, n_hosts=2)["tokens"]
            b = ref.batch_at(step, host_id=host, n_hosts=2)["tokens"]
            assert a.shape == (batch // 2, seq) and np.array_equal(a, b)
    first = [next(iter(p))["tokens"] for p in (mine, ref)]
    assert np.array_equal(*first)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_losses_match_the_reference(z_loss):
    r = np.random.default_rng(1)
    logits = (3 * r.normal(size=(3, 7, 50))).astype(np.float32)
    tokens = r.integers(0, 50, (3, 7)).astype(np.int32)
    want = RL.softmax_xent(jnp.asarray(logits), jnp.asarray(tokens),
                           z_loss=z_loss)
    lt = torch.tensor(logits, requires_grad=True)
    got = TL.softmax_xent(lt, torch.from_numpy(tokens), z_loss=z_loss)
    _rel_close(got.detach(), want, 1e-6)
    # the gradients, through the max's stop-gradient and the z-loss term
    gw = jax.grad(lambda x: RL.softmax_xent(x, jnp.asarray(tokens),
                                            z_loss=z_loss))(
        jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-8)
    want = RL.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                              aux=0.5, z_loss=z_loss)
    got = TL.next_token_loss(torch.from_numpy(logits),
                             torch.from_numpy(tokens), aux=0.5,
                             z_loss=z_loss)
    _rel_close(got, want, 1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_the_reference(schedule):
    for warm, total in ((10, 100), (0, 40), (100, 10000)):
        cfg = dict(lr=3e-3, warmup_steps=warm, total_steps=total,
                   min_lr_frac=0.1, schedule=schedule)
        rc, tc = RO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
        for s in list(range(0, 15)) + [total // 2, total - 1, total,
                                       total + 50]:
            want = float(RO.schedule_lr(rc, jnp.asarray(s, jnp.int32)))
            got = TO.schedule_lr(tc, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * max(want, 1e-12), \
                (schedule, s, float(got), want)
            assert float(TO.schedule_lr(tc, s)) == float(got)


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_update_matches_the_reference(clip, wd):
    r = np.random.default_rng(2)

    def tree(scale=1.0):
        # a stacked norm scale (repeats, d) is 2-D and takes decay
        return {"w": (scale * r.normal(size=(6, 5))).astype(np.float32),
                "norm": {"scale": (1 + scale * r.normal(size=(2, 5)))
                         .astype(np.float32)},
                "seg": ((scale * r.normal(size=(4,))).astype(np.float32),
                        {"b": (scale * r.normal(size=(3, 2, 2)))
                         .astype(np.float32)})}

    params, grads = tree(), tree(0.5)
    m, v = tree(0.01), jax.tree_util.tree_map(np.abs, tree(0.01))
    cfg = dict(lr=1e-2, weight_decay=wd, grad_clip=clip, warmup_steps=2,
               total_steps=20)
    rstate = RO.AdamWState(jnp.asarray(3, jnp.int32),
                           jax.tree_util.tree_map(jnp.asarray, m),
                           jax.tree_util.tree_map(jnp.asarray, v))
    rp, rs, rmet = RO.adamw_update(RO.AdamWConfig(**cfg),
                                   jax.tree_util.tree_map(jnp.asarray, grads),
                                   rstate,
                                   jax.tree_util.tree_map(jnp.asarray,
                                                          params))

    def tt(x):
        return TO.tree_map(torch.from_numpy, x)

    tstate = TO.AdamWState(torch.tensor(3, dtype=torch.int32), tt(m), tt(v))
    tp, ts, tmet = TO.adamw_update(TO.AdamWConfig(**cfg), tt(grads), tstate,
                                   tt(params))
    assert int(ts.step) == int(rs.step) == 4
    for key in ("lr", "grad_norm"):
        _rel_close(tmet[key], rmet[key], 1e-6)
    for got, want in ((tp, rp), (ts.m, rs.m), (ts.v, rs.v)):
        for g, w in zip(TO.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------


def _configs(name):
    if name == "qwen3-0.6b":
        return (RARCHS[name].reduced(vocab_size=64),
                ARCHS[name].reduced(vocab_size=64))
    return RARCHS[name].reduced(), ARCHS[name].reduced()


def _setup(name, seq=16, batch=4, **opt):
    rcfg, tcfg = _configs(name)
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40, weight_decay=0.1)
    kw.update(opt)
    pipe = RPipe(RPipeCfg(vocab_size=rcfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=0, branching=2))
    rstate = RTS.init_state(jax.random.PRNGKey(0), rcfg,
                            RO.AdamWConfig(**kw))
    return rcfg, tcfg, RO.AdamWConfig(**kw), TO.AdamWConfig(**kw), pipe, \
        rstate


def _check_states(tstate, rstate, lr, steps):
    for g, w in zip(TO.tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(rstate.params)):
        diff = np.abs(g.detach().numpy() - np.asarray(w))
        assert diff.max() <= 1e-5 + 2.2 * steps * lr
        assert np.mean(diff > 1e-5 + 1e-2 * lr) <= 1e-3
    assert int(tstate.opt.step) == int(rstate.opt.step) == steps


def _run_both(name, steps=2, *, remats=(True,), compression=None, **opt):
    """``steps`` steps of the reference's jitted step (remat on) and of
    the port's, once per entry of ``remats``, from the same state and
    batches."""
    rcfg, tcfg, ropt, topt, pipe, rstate0 = _setup(name, **opt)
    rstep = jax.jit(RTS.make_train_step(
        rcfg, ropt, remat=True, compression=None if compression is None
        else r_make_compression(**compression)))
    batches = [pipe.batch_at(i)["tokens"] for i in range(steps)]
    rstate, rms = rstate0, []
    for b in batches:
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(b)})
        rms.append(rm)
    for remat in remats:
        tstep = TTS.make_train_step(
            tcfg, topt, remat=remat, compression=None if compression is None
            else LT.make_compression(**compression))
        tstate = TTS.state_from_numpy(_np(rstate0), tcfg, device=CPU)
        for b, rm in zip(batches, rms):
            tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(b)})
            for key in ("loss", "grad_norm", "lr"):
                _rel_close(tm[key], rm[key], 2e-4)
        _check_states(tstate, rstate, ropt.lr, steps)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_train_step_matches_the_reference(name):
    """The port's step with remat on and off against the reference's."""
    _run_both(name, remats=(True, False))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_microbatch_equals_the_full_batch(name):
    """Microbatch 2 against the full batch with clipping off, as
    tests/test_train_substrate.py holds the reference's (float32 sums of
    two halves against one, divided by 2)."""
    _, tcfg, _, topt, pipe, rstate = _setup(name, grad_clip=1e9)
    batch = {"tokens": torch.from_numpy(pipe.batch_at(0)["tokens"])}
    out = []
    for mb in (None, 2):
        step = TTS.make_train_step(tcfg, topt, remat=False, microbatch=mb)
        out.append(step(TTS.state_from_numpy(_np(rstate), tcfg, device=CPU),
                        batch))
    (s1, m1), (s2, m2) = out
    _rel_close(m2["loss"], m1["loss"], 1e-5)
    for a, b in zip(TO.tree_leaves(s1.params), TO.tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-5)
    with pytest.raises(ValueError, match="microbatches"):
        TTS.make_train_step(tcfg, topt, microbatch=3)(s1, batch)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_compression_matches_the_reference(name):
    """The paper's QAT transform (8 bits, sparsity 0.5) in the forward
    only, as `repro.launch.train.make_compression` applies it."""
    _run_both(name, steps=1, compression=dict(bits=8, sparsity=0.5))
    assert LT.make_compression() is None


def test_remat_keeps_the_gradient_and_refuses_the_dots_policy():
    """Remat on, remat off and the "dots" policy (the products' outputs
    kept, the rest recomputed; once refused, now ported) give the same
    gradients to the bit."""
    _, tcfg = _configs("qwen3-0.6b")
    params = T.init(torch.Generator().manual_seed(0), tcfg, device=CPU)
    tokens = torch.randint(0, tcfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    grads = []
    dots = dataclasses.replace(tcfg, remat_policy="dots")
    for cfg, remat in ((tcfg, True), (tcfg, False), (dots, True)):
        leaves = [p.detach().requires_grad_(True)
                  for p in TO.tree_leaves(params)]
        logits, _ = T.forward(TO.tree_unflatten(params, leaves),
                              {"tokens": tokens}, cfg, remat=remat)
        grads.append(torch.autograd.grad(logits.square().mean(), leaves))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------


def _tiny():
    _, cfg = _configs("qwen3-0.6b")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=64, seq_len=16, global_batch=4, seed=0, branching=2))
    opt = TO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40,
                         weight_decay=0.0)
    return cfg, pipe, opt


def test_trainer_resume_is_seamless(tmp_path):
    """As tests/test_train_substrate.py: 3 steps with a checkpoint every 2
    and at the end, then a new trainer resumes at step 3 and runs to 5; its
    losses equal those of an uninterrupted run of 5 within the reference's
    rtol 2e-3 (here equal to the bit: the CPU run is deterministic)."""
    cfg, pipe, opt = _tiny()
    t1 = Trainer(cfg, opt, TrainerConfig(
        total_steps=3, ckpt_every=2, log_every=1,
        ckpt_dir=str(tmp_path)), pipe, device="cpu")
    t1.run()
    t2 = Trainer(cfg, opt, TrainerConfig(
        total_steps=5, ckpt_every=2, log_every=1,
        ckpt_dir=str(tmp_path)), pipe, device="cpu")
    _, start = t2.init_or_resume(t2.default_generator())
    assert start == 3
    out = t2.run()
    assert out["last_step"] == 4 and not out["preempted"]
    t3 = Trainer(cfg, opt, TrainerConfig(total_steps=5, log_every=1), pipe,
                 device="cpu")
    t3.run()
    resumed = {r["step"]: r["loss"] for r in t2.history}
    ref = {r["step"]: r["loss"] for r in t3.history}
    assert sorted(resumed) == [3, 4]
    for s in (3, 4):
        np.testing.assert_allclose(resumed[s], ref[s], rtol=2e-3)
        assert resumed[s] == ref[s]
    assert t3.history[-1]["loss"] < t3.history[0]["loss"]


def test_checkpoint_copies_a_donated_state_before_the_next_step(tmp_path):
    """The trainer's step writes the state in place (donated). A
    checkpoint saved before that step holds the state as it was at the
    save, though the writer thread writes it only after the step: `save`
    copies every leaf to the host first, CPU tensors too."""
    cfg, pipe, opt = _tiny()
    state = TTS.init_state(torch.Generator().manual_seed(0), cfg, opt,
                           device=CPU)
    want = [t.clone() for t in TO.tree_leaves(state)]
    mgr = CheckpointManager(tmp_path)
    gate, write = threading.Event(), mgr._write
    mgr._write = lambda job: (gate.wait(), write(job))
    mgr.save(0, state, meta={"step": 0})
    step = TTS.make_train_step(cfg, opt, remat=False)
    new, _ = step(state, {"tokens": torch.from_numpy(
        pipe.batch_at(0)["tokens"])})
    moved = [not torch.equal(a, b) for a, b in zip(TO.tree_leaves(new),
                                                   want)]
    assert TO.tree_leaves(new)[0] is TO.tree_leaves(state)[0] and any(moved)
    gate.set()
    mgr.wait()
    restored, meta = mgr.restore(like=state)
    assert meta["step"] == 0
    for a, b in zip(TO.tree_leaves(restored), want):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_stops(tmp_path):
    cfg, pipe, opt = _tiny()
    tr = Trainer(cfg, opt, TrainerConfig(
        total_steps=50, ckpt_every=1000, log_every=1,
        ckpt_dir=str(tmp_path)), pipe, device="cpu")
    orig = tr.step_fn

    def step_and_preempt(state, batch):
        tr.request_preemption()
        return orig(state, batch)
    tr.step_fn = step_and_preempt
    out = tr.run()
    assert out["preempted"] and out["last_step"] == 0
    assert tr.ckpt.latest_step() == 0
    restored, meta = tr.ckpt.restore(like=tr.state)
    assert isinstance(restored, TTS.TrainState) and meta["step"] == 0
    for a, b in zip(TO.tree_leaves(restored), TO.tree_leaves(tr.state)):
        assert torch.equal(a, b)


def test_trainer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, pipe, opt = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, opt, TrainerConfig(total_steps=1), pipe)


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-0.6b", []), ("falcon-mamba-7b", []),
    ("qwen3-0.6b", ["--qat-bits", "8", "--sparsity", "0.5",
                    "--microbatch", "1"]),
    ("whisper-base", []), ("llama-3.2-vision-11b", [])])
def test_launch_train_on_the_cpu(arch, extra, tmp_path, capsys):
    out = LT.main(["--arch", arch, "--reduced", "--steps", "3",
                   "--seq-len", "12", "--global-batch", "2",
                   "--ckpt-dir", str(tmp_path), "--device", "cpu"] + extra)
    assert out["last_step"] == 2 and np.isfinite(out["final_loss"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["last_step"] == 2 and "history" not in last
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
    # whisper's and the vision model's batches carry zero frames or
    # patches beside the tokens, as the reference's launcher feeds them
    cfg = ARCHS[arch].reduced()
    extra = LT.extra_batch(cfg, 2, CPU)
    if cfg.encoder is None and cfg.vision is None:
        assert extra is None
    else:
        (key, ctx), = extra(0).items()
        n = cfg.encoder.num_frames if cfg.encoder else cfg.vision.num_patches
        assert key == ("frames" if cfg.encoder else "patches")
        assert ctx.shape == (2, n, cfg.d_model) and not ctx.any()
