#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure, each with its seconds printed:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``src/repro_torch/csrc`` with nvcc,
   one process per source, all started together (build time and the
   ``-Xptxas -v`` registers and spills printed);
3. K1 (netlist_sim) against its plain PyTorch version and the numpy oracle
   on the card, bit for bit (a real mixed-size WhiteWine population
   compiled by the port, a many-level population, an int64-lane
   population, batches that are not a block multiple);
4. the paper's main path through its user entry point: the hardware-aware
   search on WhiteWine (11-10-7, population 8, 3 generations, 60 epochs) on
   CUDA, with every kernel's launch count read just after it; then the
   chosen point compiled and checked (netlist-exact accuracy == integer
   forward, structural == analytic cost);
5. K1's time on the card (CUDA events) and its plain version's at the main
   path's shapes, beside the least time the card could take, and the
   device's busy share during the largest population finetune;
6. K2 (quant_matmul) against its plain version on the card: qwen3-0.6b's 7
   weight shapes at the decode batch of 8 and a ragged shape, bf16 and
   float32, within the bound stated beside the plain version;
7. K5 (flash_attention) against its plain version on the card: the prefill
   shape, a ragged length, a window and a softcap case, bf16 and float32;
8. LM serving, prefill: ``make_prefill_step`` on qwen3-0.6b at full width
   (seeded random bf16 weights, 4 prompts of 1024 tokens), K5's launches
   counted (28), the last-position logits held against the same step on
   K5's plain version;
9. LM serving, quantized decode: ``make_quant_serve_step`` on w8 weights,
   batch 8, 32 prompt tokens fed one at a time, then 32 greedy tokens,
   K2's launches counted (196 a step); the same token sequence teacher-forced
   through the kernel and through K2's plain version, logits compared per
   step; the device's busy share during decode;
10. LM serving, dense: ``ServeEngine`` (batch 4, max_len 256) answers 6
   requests of 16 prompt and 16 new tokens; tokens/s, and the busy share
   over one short wave;
11. K2's and K5's times on the card at those shapes (CUDA events, weights
   and inputs rotated through more than the L2 cache), their plain
   versions', one PyTorch library call's for the same function (a
   yardstick only), and their bounds;
12. K6 (ssm_scan) against its plain version on the card: falcon-mamba-7b's
   prefill shape, a ragged T, a ragged d, a state of 4, bf16 and float32,
   within the bound stated beside the plain version;
13. K2 at falcon-mamba-7b's decode shapes (in_proj, x_proj, dt_proj on its
   float32 input, out_proj, the untied LM head) against its plain version;
14. falcon-mamba-7b prefill at full width (seeded random bf16 weights,
   7,272,665,088 parameters, 4 prompts of 1024 tokens), K6's launches
   counted (64), the last-position logits on 2 prompts of 256 tokens held
   against the same step on K6's plain version;
15. falcon-mamba-7b quantized decode: w8 weights, batch 8, 16 prompt tokens
   fed one at a time, then 16 greedy tokens, K2's launches counted (257 a
   step), the same tokens teacher-forced through K2's plain version, the
   device's busy share;
16. falcon-mamba-7b dense ``ServeEngine`` (batch 4) answering 6 requests of
   16 prompt and 16 new tokens over the recurrent caches; tokens/s and the
   busy share;
17. K6's and K2's times at falcon-mamba-7b's shapes, their plain versions'
   and their bounds.

Each phase prints its seconds and the device's peak allocated memory.
Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet), as tabulated in the repo's
# measurement notes: HBM3 rate, and the float32 CUDA-core rate — the guide's
# table has no int32 rate, and the card's int32 issue rate is not higher,
# so dividing integer ops by it gives a lower bound.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core rate
TF32_TENSOR_FLOPS = 495e12     # dense TF32 rate: the most a float32 product
                               # could reach, so a lower bound on its time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def synth_compiled(MZ, dims, bits, *, seed, sparsity=0.0, clusters=None):
    """A CompiledMLP with random integer weights on the quantization grid."""
    import numpy as np
    r = np.random.default_rng(seed)
    q_layers, scales, biases, cls, w_bits = [], [], [], [], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        qmax = 2 ** (bits - 1) - 1
        if clusters:
            cb = r.integers(-qmax, qmax + 1, (d_in, clusters)).astype(
                np.int64)
            idx = r.integers(0, clusters, (d_in, d_out))
            q = np.take_along_axis(cb, idx, axis=1)
            q = q * (r.random((d_in, d_out)) >= sparsity)
            cls.append((idx, cb))
        else:
            q = r.integers(-qmax, qmax + 1, (d_in, d_out)).astype(np.int64)
            q[r.random((d_in, d_out)) < sparsity] = 0
            cls.append(None)
        q_layers.append(q)
        scales.append(float(r.uniform(0.002, 0.02)))
        biases.append(r.normal(0, 0.3, d_out).astype(np.float32))
        w_bits.append(bits)
    return MZ.CompiledMLP(q_layers, scales, biases, cls, w_bits, 8)


class Phase:
    """Prints a phase's wall seconds and the device's peak allocated memory
    when it ends."""

    def __init__(self, n: int, name: str):
        self.n, self.name = n, name

    def __enter__(self):
        import torch
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if exc[0] is None:
            print(f"[{self.n}] phase '{self.name}': "
                  f"{time.perf_counter() - self.t0:.3f} s, peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB")


def device_busy(fn):
    """(wall s, device busy s, kernels): ``fn`` once on the host clock,
    then once under ``torch.profiler``, whose CUDA kernel times are summed
    (busy share = busy / wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    check(busy_s > 0, "the profiler saw no device time")
    return wall_s, busy_s, sum(e.count for e in events)


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# qwen3-0.6b's 7 weight shapes (K, N) of one layer at decode: q, k, v, o,
# gate, up, down
QWEN3_QMM = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
             "wo": (2048, 1024), "wi_gate": (1024, 3072),
             "wi_up": (1024, 3072), "mlp_wo": (3072, 1024)}
# the bound below which the model-level comparisons must stay: one bf16
# rounding (2^-8 relative) of the residual stream in each of 28 layers,
# added up without amplification
LM_REL_BOUND = 28 * 2.0 ** -8


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _rotating_ms(fn, sets, reps: int) -> float:
    """CUDA-event time of ``fn(*sets[i % len(sets)])``: more distinct input
    sets than the 50 MB L2 holds, as the model finds each layer's weights
    (28 layers of weights pass through L2 between two uses)."""
    it = [0]

    def step():
        fn(*sets[it[0] % len(sets)])
        it[0] += 1

    return event_ms(step, reps=reps, warmup=len(sets))


def lm_serving(card: str, dev):
    """Phases 6-11: K2 and K5 on the card, then qwen3-0.6b serving at full
    width through prefill, quantized decode and the dense engine. Returns
    the kernels' entries of the ``{"kernels": [...]}`` line."""
    import dataclasses
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.nn import attention as A
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.train_state import make_prefill_step

    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    # -- 6. K2 against its plain version ---------------------------------
    qmm_err = 0.0
    with Phase(6, "quant_matmul vs plain"):
        shapes = [(8,) + kn for kn in QWEN3_QMM.values()] + [(5, 1000, 3000)]
        for (M, K, N) in shapes:
            for dname, dt in dtypes.items():
                x = torch.randn((M, K), generator=gen, device=dev).to(dt)
                w = torch.randint(-127, 128, (K, N), generator=gen,
                                  device=dev, dtype=torch.int8)
                s = (torch.rand((N,), generator=gen, device=dev) + 0.1) * 0.01
                got = QM.quant_matmul(x, w, s)
                torch.cuda.synchronize()
                ref = QM.quant_matmul_ref(x, w, s)
                tol = QM.quant_matmul_tolerance(x, w, s, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                qmm_err = max(qmm_err, err)
                print(f"[6] quant_matmul M={M} K={K} N={N} {dname}: max abs "
                      f"err {err:.3e}, tolerance at that element "
                      f"{float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"within={bool((diff <= tol).all())}")
                check(bool((diff <= tol).all()),
                      f"quant_matmul disagrees at {(M, K, N)} {dname}")

    # -- 7. K5 against its plain version ---------------------------------
    fa_err = 0.0
    with Phase(7, "flash_attention vs plain"):
        cases = {  # (B, T, S, H, KV, hd, causal, window, softcap)
            "prefill": (4, 1024, 1024, 16, 8, 128, True, 0, 0.0),
            "ragged_t_1000": (2, 1000, 1000, 16, 8, 128, True, 0, 0.0),
            "window_256": (1, 700, 700, 16, 8, 128, True, 256, 0.0),
            "softcap_30": (2, 300, 300, 16, 8, 128, True, 0, 30.0),
            "non_causal_s_333": (2, 200, 333, 16, 8, 128, False, 0, 0.0),
        }
        for name, (B, Tq, S, H, KV, hd, causal, window, cap) in \
                cases.items():
            for dname, dt in dtypes.items():
                q = torch.randn((B, Tq, H, hd), generator=gen,
                                device=dev).to(dt)
                k = torch.randn((B, S, KV, hd), generator=gen,
                                device=dev).to(dt)
                v = torch.randn((B, S, KV, hd), generator=gen,
                                device=dev).to(dt)
                kw = dict(causal=causal, window=window, softcap=cap)
                got = FA.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                ref = FA.flash_attention_plain(q, k, v, **kw)
                tol = FA.flash_attention_tolerance(v, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                fa_err = max(fa_err, err)
                print(f"[7] flash_attention {name} B={B} T={Tq} S={S} H={H} "
                      f"KV={KV} hd={hd} {dname}: max abs err {err:.3e}, "
                      f"tolerance at that element "
                      f"{float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"within={bool((diff <= tol).all())}")
                check(bool((diff <= tol).all()),
                      f"flash_attention disagrees on {name} {dname}")
                del q, k, v, got, ref, tol, diff

    # -- 8. prefill at full width ----------------------------------------
    cfg = ARCHS["qwen3-0.6b"]
    with Phase(8, "qwen3-0.6b prefill"):
        t0 = time.perf_counter()
        params = T.init(gen, cfg, device=dev)
        torch.cuda.synchronize()
        n_params = T.param_count(params)
        print(f"[8] qwen3-0.6b: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters drawn "
              f"in {time.perf_counter() - t0:.3f} s")
        prefill = make_prefill_step(cfg)
        Bp, Tp = 4, 1024
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bp, Tp),
                                         generator=gen, device=dev)}
        reset_launches()
        last = prefill(params, batch)
        torch.cuda.synchronize()
        k5_launches = LAUNCHES["flash_attention"]
        launches = dict(LAUNCHES)
        print(f"[8] prefill 4 x 1024 tokens: launches {launches}")
        check(k5_launches == cfg.num_layers,
              f"prefill launched flash_attention {k5_launches} times, not "
              f"{cfg.num_layers}")
        check(tuple(last.shape) == (Bp, cfg.vocab_size)
              and bool(torch.isfinite(last).all()),
              "prefill logits not finite or of the wrong shape")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        A.flash_attention = FA.flash_attention_plain
        try:
            last_plain = prefill(params, batch)
        finally:
            A.flash_attention = FA.flash_attention
        rel = _rel(last, last_plain)
        agree = float((last.argmax(-1) == last_plain.argmax(-1)).float()
                      .mean())
        print(f"[8] {card}: prefill {prefill_s:.4f} s "
              f"({Bp * Tp / prefill_s:.0f} tokens/s); last-position logits "
              f"vs K5's plain version: relative L2 {rel:.3e} (bound "
              f"{LM_REL_BOUND:.3e}), max abs {float((last - last_plain).abs().max()):.3e}, "
              f"argmax agreement {agree:.3f}")
        check(rel <= LM_REL_BOUND, "prefill logits differ from the plain "
              "version's beyond the bound")
        del last, last_plain

    # -- 9. quantized decode at full width ---------------------------------
    with Phase(9, "qwen3-0.6b quantized decode"):
        qparams = QS.quantize_params(params, bits=8)
        serve = QS.make_quant_serve_step(cfg)
        Bd, P, G = 8, 32, 32
        prompt = torch.randint(0, cfg.vocab_size, (Bd, P), generator=gen,
                               device=dev)
        state = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
        fed = []
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        nxt = None
        for t in range(P + G):
            if t == P:
                torch.cuda.synchronize()
                t_gen = time.perf_counter()
            inp = prompt[:, t:t + 1] if t < P else nxt
            fed.append(inp)
            nxt, state = serve(qparams, state, inp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = dict(LAUNCHES)
        k2_launches = launches["quant_matmul"]
        print(f"[9] quantized decode, batch {Bd}, {P} prompt + {G} greedy "
              f"steps: launches {launches} "
              f"({k2_launches / (P + G):.0f} quant_matmul a step)")
        check(k2_launches == 7 * cfg.num_layers * (P + G),
              f"quant_matmul launched {k2_launches} times in {P + G} steps")
        gen_s = t1 - t_gen
        print(f"[9] {card}: decode {(t1 - t0) / (P + G) * 1e3:.3f} ms a "
              f"step; greedy part {Bd * G / gen_s:.1f} tokens/s")

        def teacher_forced():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            out = []
            for inp in fed:
                lg, st = T.decode_step(qparams, st, inp, cfg)
                out.append(lg[:, 0])
            return torch.stack(out)

        kern = teacher_forced()
        L.quant_matmul = QM.quant_matmul_ref
        try:
            plain = teacher_forced()
        finally:
            L.quant_matmul = QM.quant_matmul
        rels = [_rel(kern[i], plain[i]) for i in range(P + G)]
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        fed_greedy = torch.cat(fed[P:], 1)        # tokens the step chose
        gen_greedy = kern[P - 1:-1].argmax(-1).t()
        print(f"[9] teacher-forced logits, kernel vs K2's plain version, "
              f"per step relative L2: " + " ".join(f"{r:.2e}" for r in rels))
        print(f"[9] max abs per step: " + " ".join(
            f"{float((kern[i] - plain[i]).abs().max()):.2e}"
            for i in range(P + G)))
        print(f"[9] argmax agreement {agree:.4f} over {Bd * (P + G)} "
              f"positions; the serve step's greedy tokens reproduced: "
              f"{bool((fed_greedy == gen_greedy).all())}")
        check(bool(torch.isfinite(kern).all()), "decode logits not finite")
        check(bool((fed_greedy == gen_greedy).all()),
              "teacher-forced kernel run does not reproduce the greedy "
              "tokens of the serve step")
        check(max(rels) <= LM_REL_BOUND, "decode logits differ from the "
              "plain version's beyond the bound")
        del kern, plain

        def eight_steps():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            for inp in fed[:8]:
                serve(qparams, st, inp)

        wall_s, busy_s, n_k = device_busy(eight_steps)
        print(f"[9] {card}: 8 quantized decode steps: wall {wall_s:.4f} s, "
              f"device busy {busy_s:.4f} s in {n_k} kernels, busy share "
              f"{busy_s / wall_s:.3f}")

    # -- 10. dense serving engine at full width -----------------------------
    with Phase(10, "qwen3-0.6b ServeEngine"):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
                   for _ in range(6)]

        eng = ServeEngine(params, cfg, batch=4, max_len=256, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        print(f"[10] launches {dict(LAUNCHES)} (no Pallas kernel lies on "
              f"the dense path)")
        check(all(r.done and len(r.output) == 16
                  and all(0 <= t < cfg.vocab_size for t in r.output)
                  for r in reqs), "ServeEngine left a request unanswered")
        check(eng.stats.requests_completed == 6
              and eng.stats.tokens_generated == 96, f"stats {eng.stats}")
        print(f"[10] {card}: ServeEngine batch 4, 6 requests x (16 + 16) "
              f"tokens: {serve_s:.3f} s, {eng.stats.steps} steps, "
              f"{eng.stats.tokens_generated / serve_s:.1f} tokens/s; "
              f"stats {dataclasses.asdict(eng.stats)}")
        print(f"[10] request 0 output {reqs[0].output}")
        # busy share over a short steady window (the profiler's own
        # bookkeeping of a whole run's 2e5 kernels takes minutes): one wave
        # of 4 requests x (4 + 4) tokens, 7 engine steps
        def one_wave():
            ServeEngine(params, cfg, batch=4, max_len=256, device=dev).run(
                [Request(rid=i, prompt=p[:4], max_new_tokens=4)
                 for i, p in enumerate(prompts[:4])])

        wall_s, busy_s, n_k = device_busy(one_wave)
        print(f"[10] {card}: ServeEngine, one wave of 7 steps: wall "
              f"{wall_s:.4f} s, device busy {busy_s:.4f} s in {n_k} kernels, "
              f"busy share {busy_s / wall_s:.3f}")
        del qparams, state

    # -- 11. times at the main path's shapes -------------------------------
    with Phase(11, "quant_matmul and flash_attention times"):
        M = 8
        k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
        for name, (K, N) in QWEN3_QMM.items():
            copies = max(2, math.ceil(120e6 / (K * N)))
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            sets = [(x, torch.randint(-127, 128, (K, N), generator=gen,
                                      device=dev, dtype=torch.int8),
                     torch.rand((N,), generator=gen, device=dev) * 0.01)
                    for _ in range(copies)]
            ms = _rotating_ms(QM.quant_matmul, sets, reps=4 * copies)
            plain_ms = _rotating_ms(QM.quant_matmul_ref, sets, reps=copies)
            deq = [(x, L.dequantize({"q": w, "scale": s}, torch.bfloat16))
                   for _, w, s in sets]
            lib_ms = _rotating_ms(torch.matmul, deq, reps=4 * copies)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            flops = 2 * M * K * N
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / BF16_TENSOR_FLOPS) * 1e3
            print(f"[11] {card}: quant_matmul {name} M={M} K={K} N={N} bf16: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                  f"on the dequantized bf16 weight {lib_ms:.4f} ms, bound "
                  f"{bound:.5f} ms ({nbytes} bytes)")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bytes", nbytes),
                             ("flops", flops)):
                k2[key] += val
            del sets, deq
        k2_bytes_ms = k2["bytes"] / HBM_BYTES_PER_S * 1e3
        k2_ops_ms = k2["flops"] / BF16_TENSOR_FLOPS * 1e3
        print(f"[11] {card}: quant_matmul, one decode layer (7 shapes): "
              f"kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, "
              f"library {k2['library_ms']:.4f} ms, bound "
              f"{max(k2_bytes_ms, k2_ops_ms):.5f} ms")

        B, Tq, H, KV, hd = 4, 1024, 16, 8, 128
        sets = []
        for _ in range(3):
            sets.append(tuple(
                torch.randn(shape, generator=gen, device=dev).to(
                    torch.bfloat16)
                for shape in ((B, Tq, H, hd), (B, Tq, KV, hd),
                              (B, Tq, KV, hd))))
        fa_ms = _rotating_ms(FA.flash_attention, sets, reps=30)
        fa_plain_ms = _rotating_ms(FA.flash_attention_plain, sets, reps=6)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        check(_rel(sdpa(*sets[0]).transpose(1, 2).float(),
                   FA.flash_attention(*sets[0]).float()) < 1e-2,
              "SDPA yardstick computes another function")
        fa_lib_ms = _rotating_ms(sdpa, sets, reps=30)
        pairs = B * H * Tq * (Tq + 1) // 2          # visible (t, s), causal
        fa_flops = 4 * hd * pairs
        fa_bytes = 2 * (2 * B * Tq * H * hd + 2 * B * Tq * KV * hd)
        fa_bytes_ms = fa_bytes / HBM_BYTES_PER_S * 1e3
        fa_ops_ms = fa_flops / BF16_TENSOR_FLOPS * 1e3
        print(f"[11] {card}: flash_attention B={B} T=S={Tq} H={H} KV={KV} "
              f"hd={hd} causal bf16: kernel {fa_ms:.4f} ms, plain "
              f"{fa_plain_ms:.4f} ms, SDPA {fa_lib_ms:.4f} ms, bound "
              f"{max(fa_bytes_ms, fa_ops_ms):.5f} ms ({fa_flops} flops, "
              f"{fa_bytes} bytes)")

    return [
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:40",
         "launches": k2_launches, "max_abs_err": qmm_err,
         "tolerance": "quant_matmul_tolerance (2 K eps32 sum|x w| "
                      "+ 2^-7 |y| for bf16)",
         "shapes": "qwen3-0.6b's 7 decode products of one layer, M=8, bf16; "
                   "times summed",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2_bytes_ms, k2_ops_ms),
         "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
         "library_ms": k2["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
         "launches": k5_launches, "max_abs_err": fa_err,
         "tolerance": "flash_attention_tolerance (2 S eps32 max|v| "
                      "+ 2^-7 |o| for bf16)",
         "shapes": "prefill B=4 T=S=1024 H=16 KV=8 hd=128 causal bf16",
         "ms": fa_ms, "plain_ms": fa_plain_ms,
         "bound_ms": max(fa_bytes_ms, fa_ops_ms),
         "bound_by": "bytes" if fa_bytes_ms >= fa_ops_ms else "operations",
         "library_ms": fa_lib_ms},
    ]


def ssm_inputs(gen, B, T, d, N, dtype, dev):
    """Selective-scan inputs as the model makes them: u, B_, C_ in
    ``dtype``; dt = softplus(normal - 1), A = -(1..N) times a log-normal
    factor, D, all float32."""
    import torch
    import torch.nn.functional as F

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u = normal(B, T, d).to(dtype)
    dt = F.softplus(normal(B, T, d) - 1.0)
    B_, C_ = normal(B, T, N).to(dtype), normal(B, T, N).to(dtype)
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32) \
        * torch.exp(0.3 * normal(d, N))
    return u, dt, B_, C_, A, normal(d)


def qmm_bound_ms(M, K, N, x_bytes):
    """(bound ms, "bytes" or "operations") of y = x @ dequant(w): x read,
    int8 weight and scales read, y written once; 2MKN operations at the
    bf16 tensor-core rate (float32 x: the TF32 rate, the most a float32
    product could reach)."""
    nbytes = M * K * x_bytes + K * N + N * 4 + M * N * x_bytes
    rate = BF16_TENSOR_FLOPS if x_bytes == 2 else TF32_TENSOR_FLOPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * M * K * N / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def mamba_serving(card: str, dev):
    """Phases 12-17: K6 and K2 on the card at falcon-mamba-7b's shapes, then
    falcon-mamba-7b serving at full width through prefill, quantized decode
    and the dense engine. Returns K6's entry of the ``{"kernels": [...]}``
    line and K2's numbers on this path."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.nn import layers as L
    from repro_torch.nn import ssm as S
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.train_state import make_prefill_step

    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cfg = ARCHS["falcon-mamba-7b"]
    s = cfg.ssm
    d, di, N = cfg.d_model, s.expand * cfg.d_model, s.d_state
    r = s.dt_rank
    layers = cfg.num_layers
    # one layer's 4 products at decode (K, N, x's type) and the LM head
    shapes = {"in_proj": (d, 2 * di, "bf16"),
              "x_proj": (di, r + 2 * N, "bf16"),
              "dt_proj": (r, di, "f32"),
              "out_proj": (di, d, "bf16"),
              "lm_head": (d, cfg.vocab_size, "bf16")}
    # one bf16 rounding (2^-8 relative) of the residual stream in each of
    # 64 layers, added up without amplification
    rel_bound = layers * 2.0 ** -8

    # -- 12. K6 against its plain version --------------------------------
    ssm_err = 0.0
    with Phase(12, "ssm_scan vs plain"):
        cases = {  # (B, T, d, N)
            "prefill": (4, 1024, di, N),
            "ragged_t_333": (2, 333, di, N),
            "ragged_d_1000": (2, 256, 1000, N),
            "state_4": (2, 256, 2048, 4),
        }
        for name, (B, Tq, dd, n) in cases.items():
            for dname, dt in dtypes.items():
                args = ssm_inputs(gen, B, Tq, dd, n, dt, dev)
                got = SS.ssm_scan(*args)
                torch.cuda.synchronize()
                ref = SS.ssm_scan_ref(*args)
                tol = SS.ssm_scan_tolerance(*args, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                ssm_err = max(ssm_err, err)
                ok = bool((diff <= tol).all())
                print(f"[12] ssm_scan {name} B={B} T={Tq} d={dd} N={n} "
                      f"{dname}: max abs err {err:.3e}, tolerance at that "
                      f"element {float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"smallest tolerance {float(tol.min()):.3e}, "
                      f"within={ok}")
                check(ok, f"ssm_scan disagrees on {name} {dname}")
                del args, got, ref, tol, diff

    # -- 13. K2 at this model's shapes -----------------------------------
    qmm_err = 0.0
    with Phase(13, "quant_matmul vs plain, falcon-mamba-7b shapes"):
        for name, (K, Nn, xname) in shapes.items():
            for dname in sorted({xname, "f32"}):
                x = torch.randn((8, K), generator=gen, device=dev).to(
                    dtypes[dname])
                w = torch.randint(-127, 128, (K, Nn), generator=gen,
                                  device=dev, dtype=torch.int8)
                sc = (torch.rand((Nn,), generator=gen, device=dev) + 0.1) \
                    * 0.01
                got = QM.quant_matmul(x, w, sc)
                torch.cuda.synchronize()
                ref = QM.quant_matmul_ref(x, w, sc)
                tol = QM.quant_matmul_tolerance(x, w, sc, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                qmm_err = max(qmm_err, err)
                ok = bool((diff <= tol).all())
                print(f"[13] quant_matmul {name} M=8 K={K} N={Nn} {dname}: "
                      f"max abs err {err:.3e}, tolerance at that element "
                      f"{float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"within={ok}")
                check(ok, f"quant_matmul disagrees at {name} {dname}")
                del x, w, sc, got, ref, tol, diff

    # -- 14. prefill at full width ---------------------------------------
    with Phase(14, "falcon-mamba-7b prefill"):
        t0 = time.perf_counter()
        params = T.init(gen, cfg, device=dev)
        torch.cuda.synchronize()
        n_params = T.param_count(params)
        print(f"[14] falcon-mamba-7b: {layers} Mamba-1 layers, d_model {d}, "
              f"d_inner {di}, d_state {N}, d_conv {s.d_conv}, dt_rank {r}, "
              f"vocab {cfg.vocab_size}, untied head, {cfg.dtype}: "
              f"{n_params} parameters drawn in "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        check(n_params == 7272665088, f"{n_params} parameters, not the "
              "JAX package's 7272665088")
        prefill = make_prefill_step(cfg)
        Bp, Tp = 4, 1024
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bp, Tp),
                                         generator=gen, device=dev)}
        reset_launches()
        last = prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        k6_launches = launches["ssm_scan"]
        print(f"[14] prefill {Bp} x {Tp} tokens: launches {launches}")
        check(k6_launches == layers, f"prefill launched ssm_scan "
              f"{k6_launches} times, not {layers}")
        check(tuple(last.shape) == (Bp, cfg.vocab_size)
              and bool(torch.isfinite(last).all()),
              "prefill logits not finite or of the wrong shape")
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        print(f"[14] {card}: prefill {prefill_s:.4f} s "
              f"({Bp * Tp / prefill_s:.0f} tokens/s)")
        # against K6's plain version (a Python loop over T): 2 x 256
        small = {"tokens": batch["tokens"][:2, :256].contiguous()}
        kern = prefill(params, small)
        S.ssm_scan = SS.ssm_scan_ref
        try:
            plain = prefill(params, small)
        finally:
            S.ssm_scan = SS.ssm_scan
        rel = _rel(kern, plain)
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"[14] last-position logits on 2 x 256 tokens vs K6's plain "
              f"version: relative L2 {rel:.3e} (bound {rel_bound:.3e}), max "
              f"abs {float((kern - plain).abs().max()):.3e}, argmax "
              f"agreement {agree:.3f}")
        check(bool(torch.isfinite(kern).all()), "prefill logits not finite")
        check(rel <= rel_bound, "prefill logits differ from the plain "
              "version's beyond the bound")
        del last, kern, plain

    # -- 15. quantized decode at full width --------------------------------
    with Phase(15, "falcon-mamba-7b quantized decode"):
        qparams = QS.quantize_params(params, bits=8)
        torch.cuda.synchronize()
        print(f"[15] w8 tree beside the bf16 tree: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        serve = QS.make_quant_serve_step(cfg)
        Bd, P, G = 8, 16, 16
        prompt = torch.randint(0, cfg.vocab_size, (Bd, P), generator=gen,
                               device=dev)
        state = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
        fed = []
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        nxt = None
        for t in range(P + G):
            if t == P:
                torch.cuda.synchronize()
                t_gen = time.perf_counter()
            inp = prompt[:, t:t + 1] if t < P else nxt
            fed.append(inp)
            nxt, state = serve(qparams, state, inp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = dict(LAUNCHES)
        k2_launches = launches["quant_matmul"]
        per_step = 4 * layers + 1
        print(f"[15] quantized decode, batch {Bd}, {P} prompt + {G} greedy "
              f"steps: launches {launches} "
              f"({k2_launches / (P + G):.0f} quant_matmul a step)")
        check(k2_launches == per_step * (P + G),
              f"quant_matmul launched {k2_launches} times in {P + G} steps, "
              f"not {per_step} a step")
        check(launches["ssm_scan"] == 0, "decode launched the scan kernel")
        gen_s = t1 - t_gen
        print(f"[15] {card}: decode {(t1 - t0) / (P + G) * 1e3:.3f} ms a "
              f"step; greedy part {Bd * G / gen_s:.1f} tokens/s")

        def teacher_forced():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            out = []
            for inp in fed:
                lg, st = T.decode_step(qparams, st, inp, cfg)
                out.append(lg[:, 0])
            return torch.stack(out)

        kern = teacher_forced()
        L.quant_matmul = QM.quant_matmul_ref
        try:
            plain = teacher_forced()
        finally:
            L.quant_matmul = QM.quant_matmul
        rels = [_rel(kern[i], plain[i]) for i in range(P + G)]
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        fed_greedy = torch.cat(fed[P:], 1)
        gen_greedy = kern[P - 1:-1].argmax(-1).t()
        print("[15] teacher-forced logits, kernel vs K2's plain version, "
              "per step relative L2: " + " ".join(f"{x:.2e}" for x in rels))
        print(f"[15] argmax agreement {agree:.4f} over {Bd * (P + G)} "
              f"positions; the serve step's greedy tokens reproduced: "
              f"{bool((fed_greedy == gen_greedy).all())}")
        check(bool(torch.isfinite(kern).all()), "decode logits not finite")
        check(bool((fed_greedy == gen_greedy).all()),
              "teacher-forced kernel run does not reproduce the greedy "
              "tokens of the serve step")
        check(max(rels) <= rel_bound, "decode logits differ from the plain "
              "version's beyond the bound")
        del kern, plain

        def eight_steps():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            for inp in fed[:8]:
                serve(qparams, st, inp)

        wall_s, busy_s, n_k = device_busy(eight_steps)
        print(f"[15] {card}: 8 quantized decode steps: wall {wall_s:.4f} s, "
              f"device busy {busy_s:.4f} s in {n_k} kernels, busy share "
              f"{busy_s / wall_s:.3f}")
        del qparams, state

    # -- 16. dense serving engine at full width -----------------------------
    with Phase(16, "falcon-mamba-7b ServeEngine"):
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
                   for _ in range(6)]
        eng = ServeEngine(params, cfg, batch=4, max_len=64, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        print(f"[16] launches {dict(LAUNCHES)} (no Pallas kernel lies on "
              f"the dense decode path)")
        check(all(r.done and len(r.output) == 16
                  and all(0 <= t < cfg.vocab_size for t in r.output)
                  for r in reqs), "ServeEngine left a request unanswered")
        check(eng.stats.requests_completed == 6
              and eng.stats.tokens_generated == 96, f"stats {eng.stats}")
        print(f"[16] {card}: ServeEngine batch 4, 6 requests x (16 + 16) "
              f"tokens: {serve_s:.3f} s, {eng.stats.steps} steps, "
              f"{eng.stats.tokens_generated / serve_s:.1f} tokens/s; "
              f"stats {dataclasses.asdict(eng.stats)}")
        print(f"[16] request 0 output {reqs[0].output}")

        def one_wave():
            ServeEngine(params, cfg, batch=4, max_len=64, device=dev).run(
                [Request(rid=i, prompt=p[:4], max_new_tokens=4)
                 for i, p in enumerate(prompts[:4])])

        wall_s, busy_s, n_k = device_busy(one_wave)
        print(f"[16] {card}: ServeEngine, one wave of 7 steps: wall "
              f"{wall_s:.4f} s, device busy {busy_s:.4f} s in {n_k} kernels, "
              f"busy share {busy_s / wall_s:.3f}")
        del params, eng
        gc.collect()
        torch.cuda.empty_cache()

    # -- 17. times at the path's shapes ------------------------------------
    with Phase(17, "ssm_scan and quant_matmul times, falcon-mamba-7b"):
        B, Tq = 4, 1024
        sets = [ssm_inputs(gen, B, Tq, di, N, torch.bfloat16, dev)
                for _ in range(3)]              # 3 x 269 MB, past the L2
        ssm_ms = _rotating_ms(SS.ssm_scan, sets, reps=30)
        ssm_plain_ms = _rotating_ms(SS.ssm_scan_ref, sets, reps=3)
        ssm_bytes = sum(a.numel() * a.element_size() for a in sets[0]) \
            + B * Tq * di * 2                    # + y, bf16
        # N state updates of 5 operations (dt A, da h, dt u, its product
        # with B, the add) and N multiply-adds into y per (b, t, c), plus
        # D u; the N exps run on the special-function units, whose rate is
        # not in the data sheet, and are not counted
        ssm_ops = B * Tq * di * (7 * N + 2)
        ssm_bytes_ms = ssm_bytes / HBM_BYTES_PER_S * 1e3
        ssm_ops_ms = ssm_ops / SCALAR_OPS_PER_S * 1e3
        ssm_bound = max(ssm_bytes_ms, ssm_ops_ms)
        print(f"[17] {card}: ssm_scan B={B} T={Tq} d={di} N={N} bf16: "
              f"kernel {ssm_ms:.4f} ms, plain {ssm_plain_ms:.4f} ms, bound "
              f"{ssm_bound:.5f} ms ({ssm_bytes} bytes: "
              f"{ssm_bytes_ms:.5f} ms; {ssm_ops} operations: "
              f"{ssm_ops_ms:.5f} ms); {ssm_ms / ssm_bound:.1f}x the bound")
        del sets

        k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=0.0)
        M = 8
        for name, (K, Nn, xname) in shapes.items():
            xdt = dtypes[xname]
            copies = max(2, math.ceil(120e6 / (K * Nn)))
            x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
            wsets = [(x, torch.randint(-127, 128, (K, Nn), generator=gen,
                                       device=dev, dtype=torch.int8),
                      torch.rand((Nn,), generator=gen, device=dev) * 0.01)
                     for _ in range(copies)]
            ms = _rotating_ms(QM.quant_matmul, wsets, reps=4 * copies)
            plain_ms = _rotating_ms(QM.quant_matmul_ref, wsets, reps=copies)
            deq = [(x, L.dequantize({"q": w, "scale": sc}, xdt))
                   for _, w, sc in wsets]
            lib_ms = _rotating_ms(torch.matmul, deq, reps=4 * copies)
            bound, by = qmm_bound_ms(M, K, Nn, x.element_size())
            print(f"[17] {card}: quant_matmul {name} M={M} K={K} N={Nn} "
                  f"{xname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.matmul on the dequantized {xname} weight "
                  f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({by})")
            weight = layers if name != "lm_head" else 1
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound", bound)):
                k2[key] += weight * val
            del wsets, deq
        print(f"[17] {card}: quant_matmul, one falcon-mamba-7b decode step "
              f"({layers} x 4 products + LM head): kernel {k2['ms']:.3f} ms, "
              f"plain {k2['plain_ms']:.3f} ms, library "
              f"{k2['library_ms']:.3f} ms, bound {k2['bound']:.4f} ms")

    ssm_entry = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:51",
        "launches": k6_launches, "max_abs_err": ssm_err,
        "tolerance": "ssm_scan_tolerance (16 eps32 sum|C| E + 2 (N+2) "
                     "eps32 (sum|C h| + |D u|) + 2^-7 |y| for bf16)",
        "shapes": f"prefill B={B} T={Tq} d={di} N={N} bf16 u, float32 dt",
        "ms": ssm_ms, "plain_ms": ssm_plain_ms, "bound_ms": ssm_bound,
        "bound_by": "bytes" if ssm_bytes_ms >= ssm_ops_ms else "operations",
        "library_ms": None}
    qmm = {"launches": k2_launches, "max_abs_err": qmm_err,
           "falcon_mamba_step_ms": k2["ms"],
           "falcon_mamba_step_plain_ms": k2["plain_ms"],
           "falcon_mamba_step_library_ms": k2["library_ms"],
           "falcon_mamba_step_bound_ms": k2["bound"]}
    return ssm_entry, qmm


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import circuit
    from repro_torch.configs.printed_mlp import PRINTED_MLPS
    from repro_torch.core import batch_eval as BE
    from repro_torch.core import minimize as MZ
    from repro_torch.core.compression_spec import ModelMin
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.kernels import netlist_sim as NS
    from repro_torch.kernels.netlist_sim import ops as NSO
    from repro_torch import paper

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 on the card (PyTorch turns TF32 on
    # by default for cuDNN); every comparison below relies on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ---------------------------------------------------------
    # always from the sources in this checkout: drop libraries left by an
    # earlier run, so the builds (and their ptxas reports) happen here
    kernels = build.KERNELS
    with Phase(2, "build"):
        for name in kernels:
            build.library_path(name).unlink(missing_ok=True)
        build.build_many(kernels)
        for name in kernels:
            build.load(name)
            info = build.BUILD_INFO[name]
            print(f"[2] built {name} from source in {info['seconds']:.2f} s")
            print("\n".join(line for line in info["log"].splitlines()
                            if "registers" in line or "spill" in line))

    # -- 3. kernel vs plain version vs oracle, bit for bit ---------------
    with Phase(3, "netlist_sim vs plain and oracle"):
        cfg = PRINTED_MLPS["whitewine"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MZ.pretrain(cfg, device=dev)
        torch.cuda.synchronize()
        pretrain_s = time.perf_counter() - t0
        print(f"[3] pretrain whitewine (600 epochs) on cuda: {pretrain_s:.3f} s")
        _, _, xte, yte = MZ.dataset_for(cfg)
        real_specs = [ModelMin.uniform(2, bits=8),
                      ModelMin.uniform(2, bits=4, sparsity=0.4, clusters=8),
                      ModelMin.uniform(2, bits=3, sparsity=0.3),
                      ModelMin.uniform(2, bits=6, sparsity=0.6)]
        real = [circuit.compile_spec(cfg, s, epochs=20, device=dev)
                for s in real_specs]
        xq_real = np.stack([MZ.quantize_inputs(c, xte) for _, c in real])
        deep = [circuit.compile_netlist(synth_compiled(
            MZ, (11, 10, 10, 10, 10, 10, 10, 7), 2, seed=s, sparsity=0.2))
            for s in (1, 2)]
        wide = [circuit.compile_netlist(synth_compiled(
            MZ, (11, 12, 12, 7), 8, seed=3)),
            circuit.compile_netlist(synth_compiled(
                MZ, (11, 10, 7), 8, seed=4, clusters=4))]
        ragged = [circuit.compile_netlist(synth_compiled(
            MZ, (11, 6, 7), 5, seed=5, sparsity=0.3))]
        rng = np.random.default_rng(0)
        cases = {
            "real_mixed_whitewine": ([n for n, _ in real], xq_real),
            "many_levels": (deep, rng.integers(0, 256, (1000, 11))),
            "int64_lanes": (wide, rng.integers(0, 256, (513, 11))),
            "ragged_batch_197": (ragged, rng.integers(0, 256, (197, 11))),
            "ragged_batch_1": (ragged, rng.integers(0, 256, (1, 11))),
        }
        max_err = 0
        for name, (nets, x) in cases.items():
            pop = NS.pack_population(nets)
            got = NS.simulate_population(pop, x, engine="cuda", device=dev)
            torch.cuda.synchronize()
            plain = NS.simulate_population(pop, x, engine="levels", device=dev)
            oracle = NS.simulate_population_ref(pop, x)
            err = int(np.abs(got["amx"] - plain["amx"]).max())
            max_err = max(max_err, err)
            exact = (np.array_equal(got["amx"], plain["amx"])
                     and np.array_equal(got["amx"], oracle["amx"])
                     and np.array_equal(got["argmax"], plain["argmax"])
                     and np.array_equal(got["argmax"], oracle["argmax"]))
            print(f"[3] netlist_sim {name}: P={pop.n_candidates} "
                  f"N={pop.n_slots} levels={int(pop.n_levels.max())} "
                  f"B={x.shape[-2]} lanes={NSO.lane_dtype(pop)} "
                  f"bit_exact={exact}")
            check(exact, f"netlist_sim kernel disagrees on {name}")
        check(NSO.lane_dtype(NS.pack_population(wide)) == torch.int64,
              "int64 case did not take int64 lanes")
        check(len(xq_real[0]) % NSO.BLOCK != 0, "whitewine batch is a multiple")

    # -- 4. the main path: the paper's search on whitewine, on cuda ------
    with Phase(4, "whitewine search"):
        seen = {}
        kernel_wrapper = NSO.netlist_sim

        def recording_wrapper(pop, x, **kw):
            if x.shape[0] * x.shape[1] >= seen.get("size", -1):
                seen.update(size=x.shape[0] * x.shape[1], pop=pop, x=x)
            return kernel_wrapper(pop, x, **kw)

        finetune = BE._population_finetune
        finetune_s = []

        finetune_args = []

        def timed_finetune(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = finetune(*a, **kw)
            torch.cuda.synchronize()
            finetune_s.append((a[1].shape[0], time.perf_counter() - t))
            finetune_args.append((a, kw))
            return out

        compile_price = BE._compile_and_price
        compile_price_s = []

        def timed_compile_price(*a, **kw):
            t = time.perf_counter()
            out = compile_price(*a, **kw)
            compile_price_s.append(time.perf_counter() - t)
            return out

        NSO.netlist_sim = recording_wrapper
        BE._population_finetune = timed_finetune
        BE._compile_and_price = timed_compile_price
        generations = 3
        reset_launches()
        t0 = time.perf_counter()
        res = paper.run("whitewine", population=8, generations=generations,
                        epochs=60, device=dev)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        NSO.netlist_sim = kernel_wrapper
        BE._population_finetune = finetune
        BE._compile_and_price = compile_price
        print(f"[4] search on {res['device']}: {search_s:.3f} s, "
              f"{res['n_evaluations']} evaluations, launches {launches}")
        print(f"[4] baseline acc={res['baseline_acc']} "
              f"area={res['baseline_area_mm2']} mm2")
        print(f"[4] combined gain at <=5% loss: {res['combined_gain_at_5pct']}x")
        for acc, area, delay, spec in res["pareto_front"]:
            print(f"[4]   front: acc={acc} area={area} mm2 delay={delay} {spec}")
        for (p, s), c in zip(finetune_s, compile_price_s):
            print(f"[4] generation batch P={p}: finetune (60 epochs) {s:.3f} s, "
                  f"compile+simulate+price {c:.3f} s")
        rest = search_s - sum(s for _, s in finetune_s) - sum(compile_price_s)
        print(f"[4] rest of the search (baseline spec, GA, host glue): "
              f"{rest:.3f} s")
        check(res["device"].startswith("cuda"), "search did not run on cuda")
        check(launches["netlist_sim"] >= generations,
              f"netlist_sim launched {launches['netlist_sim']} times in "
              f"{generations} generations")
        check(len(res["pareto_front"]) > 0, "empty Pareto front")
        check(np.isfinite(res["combined_gain_at_5pct"]), "gain not finite")
        for acc, area, delay, _ in res["pareto_front"]:
            check(0.0 <= acc <= 1.0 and area > 0 and delay > 0,
                  "front point out of range")
        chosen = paper.chosen_point(res)
        net, compiled = circuit.compile_spec(cfg, ModelMin.from_json(chosen),
                                             epochs=60, device=dev)
        acc_net = circuit.netlist_accuracy(net, compiled, xte, yte, device=dev)
        _, cls = MZ.integer_forward(compiled,
                                    MZ.quantize_inputs(compiled, xte))
        acc_int = float(np.mean(cls == yte))
        cv = circuit.cross_validate(net, compiled)
        print(f"[4] chosen {chosen}: netlist acc={acc_net} integer_forward "
              f"acc={acc_int} structural==analytic={cv['ok']}")
        check(acc_net == acc_int, "netlist-exact accuracy != integer forward")
        check(cv["ok"], "structural cost != analytic cost")

    # -- 5. times at the main path's shapes -------------------------------
    with Phase(5, "netlist_sim times, finetune busy share"):
        pop, x = seen["pop"], seen["x"]
        P, B = x.shape[0], x.shape[1]
        staged = NSO.StagedLaunch(pop, x)
        ms = event_ms(staged.launch, reps=50)
        plain_ms = event_ms(lambda: NSO.simulate_levels(pop, x), reps=5,
                            warmup=1)
        lane = 4 if NSO.lane_dtype(pop) == torch.int32 else 8
        n = pop.n_nodes.astype(np.int64)
        valid = np.arange(pop.n_slots)[None, :] < n[:, None]
        comp = valid & (pop.op >= int(circuit.Op.SHL)) & \
            (pop.op != int(circuit.Op.ARGMAX))
        ops = int(comp.sum()) * B
        nbytes = (pop.op.size * 4 * 4 + pop.op.size * lane + P * 4
                  + pop.input_pos.size * 4 + pop.argmax_pos.size * 4
                  + x.numel() * lane + P * B * pop.n_classes * lane + P * B * 8)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[5] {card}: netlist_sim at P={P} N={pop.n_slots} B={B} "
              f"lanes={NSO.lane_dtype(pop)}: kernel {ms:.4f} ms, plain levels "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({nbytes} bytes, "
              f"{ops} integer ops)")
        print(f"[5] {card}: pretrain {pretrain_s:.3f} s; per-generation "
              f"finetune " + ", ".join(f"P={p}: {s:.3f} s"
                                       for p, s in finetune_s))

        # device busy time of the largest population finetune: kernel time
        # summed by the profiler, over the same call's unprofiled wall time
        a, kw = max(finetune_args, key=lambda t: t[0][1].shape[0])
        wall_s, busy_s, n_kernels = device_busy(lambda: finetune(*a, **kw))
        print(f"[5] {card}: population finetune P={a[1].shape[0]} "
              f"(60 epochs): wall {wall_s:.3f} s, device busy {busy_s:.4f} s "
              f"in {n_kernels} kernels, busy share {busy_s / wall_s:.3f}")
    netlist_entry = {
        "name": "netlist_sim", "route": "cuda",
        "source": "src/repro_torch/csrc/netlist_sim.cu",
        "replaces": "src/repro/kernels/netlist_sim/kernel.py:80",
        "launches": launches["netlist_sim"], "max_abs_err": max_err,
        "tolerance": 0, "bit_exact": max_err == 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}

    qmm_entry, fa_entry = lm_serving(card, dev)
    gc.collect()
    torch.cuda.empty_cache()        # the qwen3-0.6b tensors are gone
    ssm_entry, qmm_mamba = mamba_serving(card, dev)
    qmm_entry["launches_by_path"] = {
        "qwen3-0.6b w8 decode, 64 steps": qmm_entry["launches"],
        "falcon-mamba-7b w8 decode, 32 steps": qmm_mamba.pop("launches")}
    qmm_entry["launches"] = sum(qmm_entry["launches_by_path"].values())
    qmm_entry["max_abs_err"] = max(qmm_entry["max_abs_err"],
                                   qmm_mamba.pop("max_abs_err"))
    qmm_entry.update(qmm_mamba)
    print(json.dumps({"kernels": [netlist_entry, qmm_entry, fa_entry,
                                  ssm_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
