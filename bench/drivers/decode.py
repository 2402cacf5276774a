"""Decode: a closed-loop batch of requests served by the port's quantized
decode step (`serve.quantized.make_quant_serve_step`).

Set-up draws the weights, quantizes them with the port's
`quantize_params` and frees the originals, then puts each row's own
prompt into the compressed cache through the port's prompt path
(`transformer.decode_step` on ``fill_rows`` rows by ``fill_chunk`` tokens a
call, each call routing its tokens as one group). The window serves waves:
each wave rewinds every row to its prompt, feeds one fresh token a row
drawn from the seed, then ``wave_tokens`` greedy steps, every step's
tokens read back to the host as a server streams them. The wave in flight
at the close is finished outside the window.

The check runs the reference over the first ``check_rows`` rows of
``check_waves`` finished waves drawn from the seed: prompt, fresh token
and served tokens, with the program's routing groups (its fill calls, then
one group a step of all ``batch`` rows, whose first rows rank first), and
reads how far each served token's logit lies below the reference's best:
the widest gap (``logit_gap``) and the share of served tokens that are not
the reference's best (``off_best_pct``). A cell's limits file says which
it compares.
"""
from __future__ import annotations

import random
import time

import torch

from bench.harness import device as D
from bench.harness import program, trace
from bench.harness import weights as WT
from bench.harness.common import Context, Outcome, log
from bench.reference import model as R
from bench.yardstick import kernels as YK
from bench.yardstick import work as YW


def _fill(qparams, state, prompts, cfg, rows: int, chunk: int):
    from repro_torch.nn import transformer as T
    B, P = prompts.shape
    for r0 in range(0, B, rows):
        for c0 in range(0, P, chunk):
            end = min(P, c0 + chunk)
            sub = {"caches": T.map_tree(
                lambda _, t, r0=r0, end=end: t[:, r0:r0 + rows, :end],
                state["caches"]),
                   "kv_len": c0}
            T.decode_step(qparams, sub, prompts[r0:r0 + rows, c0:end], cfg)


def _groups(spec, mix, m: int, L: int, dev):
    """The routing groups of the first m rows: the fill calls, then one
    group a decode position."""
    P, rows, chunk = mix["prompt_len"], mix["fill_rows"], mix["fill_chunk"]
    b = torch.arange(m, device=dev)[:, None]
    out = []
    for c0 in range(0, P, chunk):
        t = torch.arange(c0, min(P, c0 + chunk), device=dev)[None, :]
        out.append(R.Group((b * L + t).reshape(-1),
                           R.capacity(spec, min(rows, mix["batch"])
                                      * t.numel())))
    for p in range(P, L):
        out.append(R.Group(b[:, 0] * L + p, R.capacity(spec, mix["batch"])))
    return out


def run(ctx: Context) -> Outcome:
    from repro_torch.serve import quantized as QS
    from repro_torch.nn import transformer as T

    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    cfg = program.arch(s)
    B, P, G = mix["batch"], mix["prompt_len"], mix["wave_tokens"]
    bits = mix["weights_bits"]
    V = s.vocab_size

    w = WT.make(s, ctx.seed, dev)
    qparams = QS.quantize_params(program.params(w, s, cfg), bits=bits)
    del w
    D.free(dev)
    log(ctx, "weights drawn and quantized")
    prompts = torch.randint(0, V, (B, P), device=dev,
                            generator=D.generator(dev, WT.derive(
                                ctx.seed, "prompts")))
    state = T.init_decode_state(cfg, B, P + G, cfg.dtype, device=dev)
    _fill(qparams, state, prompts, cfg, mix["fill_rows"], mix["fill_chunk"])
    D.sync(dev)
    log(ctx, f"{B} prompts of {P} tokens in the cache")
    serve = QS.make_quant_serve_step(cfg)
    wave_gen = D.generator(dev, WT.derive(ctx.seed, "waves"))
    warm = dict(state, kv_len=P)
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    for _ in range(2):
        tok, warm = serve(qparams, warm, tok)
        tok.cpu()
    del warm
    D.sync(dev)

    def step(st, inp):
        with trace.step_range("decode_step"):
            nxt, st = serve(qparams, st, inp)
        if "altered" in ctx.faults:         # a planted fault (tests)
            nxt = (nxt + 1) % V
        return nxt, st

    def wave(step_times, deadline):
        """Serve one wave until it ends or a step ends past ``deadline``;
        returns (first tokens, served tokens (list of (B, 1) on the host),
        the decode state, the end of the last step)."""
        first = torch.randint(0, V, (B, 1), device=dev, generator=wave_gen)
        st, inp, served = dict(state, kv_len=P), first, []
        for _ in range(G):
            t0 = time.perf_counter()
            inp, st = step(st, inp)
            served.append(inp.cpu())
            t1 = time.perf_counter()
            step_times.append(t1 - t0)
            if t1 >= deadline:
                break
        return first.cpu(), served, st, t1

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    step_times, waves = [], []
    while True:
        first, served, st, t_end = wave(step_times, deadline)
        if t_end >= deadline:
            break
        waves.append((first, torch.cat(served, 1)))
    window_s = t_end - t0
    # the wave in flight at the close finishes outside the window
    inp = served[-1].to(dev)
    for _ in range(G - len(served)):
        inp, st = step(st, inp)
        served.append(inp.cpu())
    waves.append((first, torch.cat(served, 1)))
    del st
    n_steps = len(step_times)
    ctx_mean = P + (G + 1) / 2
    obs = {"kind": "decode", "window_s": window_s, "step_times": step_times,
           "model_flops": n_steps * YW.decode_flops(s, B, ctx_mean),
           "model_bytes": n_steps * YW.decode_bytes(s, B, ctx_mean, bits)}

    if ctx.trace:
        out: list = []
        n_tr = mix["trace_steps"]
        with trace.traced(dev, out):
            st, inp = dict(state, kv_len=P), waves[0][0].to(dev)
            for _ in range(n_tr):
                inp, st = step(st, inp)
                inp.cpu()
        obs["trace"] = out[0]
        obs["traced_steps"] = n_tr
        obs["k2_bound_s"] = n_tr * YK.k2_step_bound_s(s, B)
        obs["k2_experts_bound_s"] = n_tr * YK.k2_experts_step_bound_s(
            s, B, bits)
    peak = D.peak_bytes(dev)
    del qparams, state
    D.free(dev)
    log(ctx, f"window {window_s:.3f} s, {n_steps} steps, {len(waves)} waves")

    checks, control = _check(ctx, prompts.cpu(), waves)
    tokens = n_steps * B
    return Outcome(
        e2e={"decode_tok_s": tokens / window_s, "setup_s": setup_s},
        attempted=len(waves) * B, failed=0, checks=checks, obs=obs,
        memory_peak_bytes=peak, control=control)


def _check(ctx: Context, prompts, waves):
    s, mix, dev = ctx.spec, ctx.mix, ctx.device
    P, G, m = mix["prompt_len"], mix["wave_tokens"], mix["check_rows"]
    bits = mix["weights_bits"]
    rng = random.Random(WT.derive(ctx.seed, "check"))
    picked = sorted(rng.sample(range(len(waves)),
                               min(mix["check_waves"], len(waves))))
    R.no_tf32()
    w = WT.make(s, ctx.seed, dev)
    ref = R.reference(s, R.weight_fetch(w, R.scales_of(w, bits), bits, dev))
    low = R.reference(s, R.weight_fetch(w, R.scales_of(w, 4), 4, dev)) \
        if ctx.control else None
    L = P + G
    groups = _groups(s, mix, m, L, dev)
    gap, gap_low = 0.0, 0.0
    n = off = off_low = 0
    with torch.no_grad():
        for i in picked:
            first, served = waves[i]
            toks = torch.cat([prompts[:m], first[:m], served[:m, :G - 1]],
                             1).to(dev)
            chosen = served[:m].to(dev).long()
            ref.margins.clear()
            h, _ = ref.hidden(toks, groups)
            lg = ref.logits(h[:, P:])
            gaps = R.gap_of(lg, chosen)
            gap = max(gap, float(gaps.max()))
            n += gaps.numel()
            off += int((gaps > 0).sum())
            at = int(gaps.argmax())
            row, col = divmod(at, G)
            near = min(float(mg[:, P:].min()) for mg in ref.margins)
            log(ctx, f"wave {i}: widest gap {float(gaps.max()):.4g} at row "
                f"{row} step {col}, margins there "
                f"{[round(float(mg[row, P + col]), 5) for mg in ref.margins]}"
                f"; {int((gaps > 0).sum())} of {gaps.numel()} tokens off the "
                f"reference's best; smallest margin {near:.3g}")
            if low is not None:
                hl, _ = low.hidden(toks, groups)
                pick = low.logits(hl[:, P:]).argmax(-1)
                gl = R.gap_of(lg, pick)
                gap_low = max(gap_low, float(gl.max()))
                off_low += int((gl > 0).sum())
                log(ctx, f"control wave {i}: widest gap {float(gl.max()):.4g}"
                    f", {int((gl > 0).sum())} tokens off")
    del w
    D.free(dev)
    log(ctx, f"checked waves {picked}, rows 0-{m - 1}")
    control = {"logit_gap": gap_low, "off_best_pct": 100.0 * off_low / n} \
        if ctx.control else {}
    return {"logit_gap": gap, "off_best_pct": 100.0 * off / n}, control
