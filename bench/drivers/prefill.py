"""Prefill: one prompt a call, closed loop, through the port's
`train_state.make_prefill_step`, each request's last-position logits read
back to the host. Prompt lengths cycle in the mix's fixed order and token
ids come from the seed, so every seed serves the same sizes in the same
order.

The check runs the reference over ``check_requests`` finished requests
drawn from the seed, one of the longest among them, each prompt routed as
one group as the program routes a call's tokens, and compares the served
last-position logits with the reference's by their relative L2 distance,
the nearest of the ways the last token's routing near-ties could go
(`last_logits`).
"""
from __future__ import annotations

import random
import time

import torch

from bench.harness import device as D
from bench.harness import program, trace
from bench.harness import weights as WT
from bench.harness.common import Context, Outcome, log, nearest_rank
from bench.reference import model as R
from bench.yardstick import kernels as YK
from bench.yardstick import work as YW

# a relative gap between the k-th and (k+1)-th router probabilities under
# which bf16 rounding upstream of the router may decide the choice either
# way (flips seen on the H100 at 0.006 and 0.007; none at 0.05 or more)
TIE_MARGIN = 0.03


def run(ctx: Context) -> Outcome:
    from repro_torch.train.train_state import make_prefill_step

    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    cfg = program.arch(s)
    V = s.vocab_size
    lengths = mix["lengths"]
    w = WT.make(s, ctx.seed, dev)
    params = program.params(w, s, cfg)
    step = make_prefill_step(cfg)

    def serve(tokens):
        with trace.step_range("prefill_step"):
            last = step(params, {"tokens": tokens})
        if "altered" in ctx.faults:          # a planted fault (tests)
            last = last.roll(1, -1)
        return last.float().cpu()

    warm_gen = D.generator(dev, WT.derive(ctx.seed, "warm"))
    for L in lengths:
        serve(torch.randint(0, V, (1, L), device=dev, generator=warm_gen))
    gen = D.generator(dev, WT.derive(ctx.seed, "prompts"))
    D.sync(dev)
    log(ctx, "weights drawn, every length warmed")

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    done = []                       # (length, ttft s, tokens, logits)
    while True:
        L = lengths[len(done) % len(lengths)]
        tok = torch.randint(0, V, (1, L), device=dev, generator=gen)
        ts = time.perf_counter()
        last = serve(tok)
        te = time.perf_counter()
        done.append((L, te - ts, tok.cpu(), last))
        if te >= deadline:
            break
    window_s = te - t0
    n_tok = sum(d[0] for d in done)
    obs = {"kind": "prefill", "window_s": window_s,
           "model_flops": sum(YW.prefill_flops(s, d[0]) for d in done)}

    if ctx.trace:
        out: list = []
        n_tr = mix["trace_requests"]
        with trace.traced(dev, out):
            for i in range(n_tr):
                serve(done[i % len(done)][2].to(dev))
        obs["trace"] = out[0]
        obs["k5_bound_s"] = sum(
            YK.k5_forward_bound_s(s, 1, done[i % len(done)][0])
            for i in range(n_tr)) * s.num_layers
    peak = D.peak_bytes(dev)
    del params, w
    D.free(dev)

    log(ctx, f"window {window_s:.3f} s, {len(done)} requests")
    checks, control = _check(ctx, done)
    log(ctx, "checked")
    return Outcome(
        e2e={"prefill_tok_s": n_tok / window_s,
             "ttft_p95_ms": 1e3 * nearest_rank([d[1] for d in done], 0.95),
             "setup_s": setup_s},
        attempted=len(done), failed=0, checks=checks, obs=obs,
        memory_peak_bytes=peak, control=control)


def last_logits(model: R.Model, toks):
    """The reference's last-position logits of one prompt, and those of
    every way the last token's near-ties could have gone: for each set of
    MoE layers where its k-th and (k+1)-th router probabilities lie within
    ``TIE_MARGIN`` of each other, the last token routed with those flipped
    (the rest of the prompt as it is: the last token is also last in its
    routing group, so no other token's capacity changes)."""
    s = model.s
    inputs: list = []
    model.margins.clear()
    model.swap = {}
    h, _ = model.hidden(toks, inputs=inputs)
    out = [model.logits(h[0, -1])]
    near = [s.n_dense + j for j, mg in enumerate(model.margins)
            if float(mg[0, -1]) < TIE_MARGIN]
    last = torch.zeros(toks.numel(), dtype=torch.bool, device=toks.device)
    last[-1] = True
    for mask in range(1, 1 << len(near)):
        layers = [near[b] for b in range(len(near)) if mask >> b & 1]
        model.swap = {i: last for i in layers}
        h, _ = model.hidden(toks, start=layers[0], h=inputs[layers[0]])
        out.append(model.logits(h[0, -1]))
    model.swap = {}
    return out, near


def _check(ctx: Context, done):
    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    rng = random.Random(WT.derive(ctx.seed, "check"))
    longest = max(d[0] for d in done)
    top = [i for i, d in enumerate(done) if d[0] == longest]
    picked = [rng.choice(top)]
    rest = [i for i in range(len(done)) if i not in picked]
    picked += rng.sample(rest, min(len(rest), mix["check_requests"] - 1))
    R.no_tf32()
    w = WT.make(s, ctx.seed, dev)
    fetch = R.weight_fetch(w, {}, 8, dev)
    ref = R.reference(s, fetch)
    low = R.reference(s, fetch, R.Precision("fp8")) if ctx.control else None
    rel = rel_low = 0.0

    def distance(got, wants):
        return min(float((got - want).norm() / want.norm())
                   for want in wants)

    with torch.no_grad():
        for i in sorted(picked):
            toks = done[i][2].to(dev)
            served = done[i][3].to(dev)[0]
            wants, near = last_logits(ref, toks)
            r_i = distance(served, wants)
            rel = max(rel, r_i)
            log(ctx, f"request {i} ({toks.shape[1]} tokens): relative L2 "
                f"{r_i:.4g} (routing as the reference: "
                f"{distance(served, wants[:1]):.4g}); near-ties of the last "
                f"token at layers {near}")
            if low is not None:
                hl, _ = low.hidden(toks)
                r_low = distance(low.logits(hl[0, -1]), wants)
                rel_low = max(rel_low, r_low)
                log(ctx, f"control: relative L2 {r_low:.4g}")
    del w
    D.free(dev)
    control = {"logits_rel_l2": rel_low} if ctx.control else {}
    return {"logits_rel_l2": rel}, control
