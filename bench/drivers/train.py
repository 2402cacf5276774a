"""Training: the port's donated train step (`train_state.make_train_step`,
remat on, AdamW) on rows of seeded tokens, every step's rows new.

Set-up builds the one train state, drives it through the mix's
``checked_steps`` first steps through the same step and feed as the
window, and reads what the check needs on the way: each step's loss, each
leaf's first gradient as the optimizer got it (its first moment after one
step over 1 - b1), and each leaf's change after the checked steps (against
the weights made again from the seed). The window then runs on from there,
one step at a time, each step waited for.

The check makes the weights again, runs the reference's float32 model and
AdamW through the same steps on the same rows, and compares the losses and,
leaf by leaf, the two norms by the worst leaf: the gap between the norms,
over the reference's norm of that leaf or of the median leaf, whichever is
larger; and each leaf's first gradient on ``SAMPLE`` elements drawn from
the seed. Leaves whose reference gradient is under a thousandth of the
median leaf's are left out (they move by round-off alone).
"""
from __future__ import annotations

import copy
import statistics
import time
from typing import Dict

import torch

from bench.harness import device as D
from bench.harness import program, trace
from bench.harness import weights as WT
from bench.harness.common import Context, Outcome, log
from bench.reference import model as R
from bench.yardstick import kernels as YK
from bench.yardstick import work as YW

NEGLIGIBLE = 1e-3
# elements of each leaf whose first gradient is compared one by one
SAMPLE = 4096


def sample_index(ctx: Context, sizes: Dict[str, int]):
    """Leaf -> the indices, drawn from the seed, of the elements whose
    first gradient is compared."""
    gen = D.generator(ctx.device, WT.derive(ctx.seed, "sample"))
    return {k: torch.randint(0, sizes[k], (SAMPLE,), device=ctx.device,
                             generator=gen) for k in sorted(sizes)}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tensors.items()}


def batches(ctx: Context):
    """The rows of each step, drawn from the seed in step order."""
    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    gen = D.generator(dev, WT.derive(ctx.seed, "batches"))
    while True:
        yield torch.randint(0, s.vocab_size, (mix["batch"], mix["seq_len"]),
                            device=dev, generator=gen)


def run(ctx: Context) -> Outcome:
    from repro_torch.nn import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_state import TrainState, make_train_step

    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    cfg = program.arch(s)
    opt_cfg = AdamWConfig(**mix["adamw"])
    w = WT.make(s, ctx.seed, dev)
    params = program.params(w, s, cfg)
    names = program.leaf_names(s)
    state = TrainState(params, adamw_init(params))
    real_step = make_train_step(cfg, opt_cfg)

    def step(state, tokens):
        if "half_batch" in ctx.faults:           # planted faults (tests)
            tokens = tokens[:tokens.shape[0] // 2]
        with trace.step_range("train_step"):
            if "unchanged" in ctx.faults:
                _, met = real_step(copy.deepcopy(state), {"tokens": tokens})
                return state, met
            return real_step(state, {"tokens": tokens})

    feed = batches(ctx)
    losses, grads, picks = [], {}, {}
    for i in range(mix["checked_steps"]):
        state, met = step(state, next(feed))
        losses.append(float(met["loss"]))
        if i == 0:
            m = {names[p]: t for p, t in T._leaves(state.opt.m)}
            grads = {k: v / (1 - opt_cfg.b1) for k, v in _norms(m).items()}
            idx = sample_index(ctx, {k: t.numel() for k, t in m.items()})
            picks = {k: (m[k].reshape(-1)[idx[k]] / (1 - opt_cfg.b1)).cpu()
                     for k in m}
            del m
    w0 = WT.make(s, ctx.seed, dev)
    now = {names[p]: t for p, t in T._leaves(state.params)}
    change = {k: float(torch.linalg.vector_norm(
        now[k].float() - w0[k].float())) for k in w0 if k in now}
    del w0, now, w
    D.free(dev)
    D.sync(dev)
    log(ctx, f"{mix['checked_steps']} checked steps, losses {losses}")

    B, L = mix["batch"], mix["seq_len"]
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    n = 0
    while True:
        state, met = step(state, next(feed))
        D.sync(dev)
        n += 1
        t_end = time.perf_counter()
        if t_end >= deadline:
            break
    window_s = t_end - t0
    obs = {"kind": "train", "window_s": window_s,
           "model_flops": n * YW.train_flops(s, B, L)}
    if ctx.trace:
        out: list = []
        n_tr = mix["trace_steps"]
        with trace.traced(dev, out):
            for _ in range(n_tr):
                state, met = step(state, next(feed))
        obs["trace"] = out[0]
        obs["k5_bwd_bound_s"] = n_tr * s.num_layers * \
            YK.k5_backward_bound_s(s, B, L)
    peak = D.peak_bytes(dev)
    del state, met, params
    D.free(dev)

    log(ctx, f"window {window_s:.3f} s, {n} steps")
    ref = reference(ctx)
    log(ctx, f"reference losses {ref[0]}")
    checks = compare(losses, grads, change, picks, ref)
    log(ctx, "first gradient, sampled elements, by leaf: " + _by_leaf(
        picks, ref[3]))
    control = {}
    if ctx.control:
        low = reference(ctx, R.Precision("fp8"))
        control = compare(*low, ref)
        log(ctx, f"control losses {low[0]}; sampled elements by leaf: "
            + _by_leaf(low[3], ref[3]))
    return Outcome(e2e={"train_tok_s": n * B * L / window_s,
                        "setup_s": setup_s},
                   attempted=n, failed=0, checks=checks, obs=obs,
                   memory_peak_bytes=peak, control=control)


def reference(ctx: Context, prec=None):
    """The reference's (losses, first gradient's norms, change's norms,
    first gradient's sampled elements) over the checked steps, in float32
    with TF32 off."""
    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    a = mix["adamw"]
    if a["schedule"] != "constant":
        raise ValueError("the reference's AdamW runs a constant rate")
    R.no_tf32()
    w = WT.make(s, ctx.seed, dev)
    p = {k: t.float().requires_grad_(True) for k, t in w.items()}
    del w
    D.free(dev)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}

    def fetch(name, *index):
        t = p[name]
        for i in index:
            t = t[i]
        return t

    model = R.reference(s, fetch, prec, grad=True)
    feed = batches(ctx)
    keys = list(p)
    # elements sampled in the leaves the program has, as its run drew them
    mine = set(program.leaf_names(s).values())
    idx = sample_index(ctx, {k: t.numel() for k, t in p.items() if k in mine})
    losses, first, picks = [], {}, {}
    for i in range(1, mix["checked_steps"] + 1):
        tokens = next(feed)
        with torch.enable_grad():
            h, aux = model.hidden(tokens)
            loss = R.next_token_loss(model, h, tokens, aux)
            g = torch.autograd.grad(loss, [p[k] for k in keys])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(x * x) for x in g))
            scale = torch.clamp(a["grad_clip"] / torch.clamp(gn, min=1e-9),
                                max=1.0)
            b1t, b2t = 1 - a["b1"] ** i, 1 - a["b2"] ** i
            warm = min(i / a["warmup_steps"], 1.0) if a["warmup_steps"] \
                else 1.0
            lr = a["lr"] * warm
            for k, gk in zip(keys, g):
                gk = gk * scale
                if i == 1:
                    first[k] = float(torch.linalg.vector_norm(gk))
                    if k in idx:
                        picks[k] = gk.reshape(-1)[idx[k]].cpu()
                m[k].mul_(a["b1"]).add_((1 - a["b1"]) * gk)
                v[k].mul_(a["b2"]).add_((1 - a["b2"]) * gk * gk)
                delta = (m[k] / b1t) / (torch.sqrt(v[k] / b2t) + a["eps"])
                if a["weight_decay"] and p[k].dim() >= 2:
                    delta = delta + a["weight_decay"] * p[k]
                p[k].sub_(lr * delta)
        del g
    del m, v
    D.free(dev)
    w0 = WT.make(s, ctx.seed, dev)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - w0[k].float()))
                  for k in keys}
    del w0, p
    D.free(dev)
    return losses, first, change, picks


def _worst(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def _by_leaf(picks, r_picks) -> str:
    return ", ".join(f"{k} {float((picks[k] - r_picks[k]).norm() / r_picks[k].norm()):.4g}"
                     for k in sorted(r_picks))


def compare(losses, grads, change, picks, ref) -> Dict[str, float]:
    """Every number read: the worst step's loss (relative), the worst
    leaf's first-gradient norm and change norm (`_worst`), and the first
    gradient on each leaf's sampled elements (relative L2), the median
    leaf's. Only the numbers with a limit are compared (PERF.md gives the
    readings of the others)."""
    r_losses, r_grads, r_change, r_picks = ref
    # the leaves the program has (a family's reference may read more)
    r_grads = {k: v for k, v in r_grads.items() if k in grads}
    med = statistics.median(r_grads.values())
    keep = [k for k in r_grads if r_grads[k] >= NEGLIGIBLE * med]
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "grad_norm": _worst(grads, r_grads, keep),
            "change_norm": _worst(change, r_change, keep),
            "grad_sample": statistics.median(
                float((picks[k] - r_picks[k]).norm() / r_picks[k].norm())
                for k in keep)}
