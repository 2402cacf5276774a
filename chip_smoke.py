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
   population, batches that are not a tile multiple, all through the
   shared-memory body, and a population past 227 KB through the
   global-scratch body); each case checks the body it took;
4. the paper's main path through its user entry point: the hardware-aware
   search on WhiteWine (11-10-7, population 8, 3 generations, 60 epochs) on
   CUDA, with every kernel's launch count read just after it (every K1
   launch through the shared-memory body); then the chosen point compiled
   and checked (netlist-exact accuracy == integer forward, structural ==
   analytic cost);
5. K1's time on the card at the main path's shapes (device time from a
   CUDA graph, an eager loop beside it) and its plain version's, beside the
   least time the card could take; the global-scratch body's and the plain
   version's on phase 3's population past a block's shared memory; the
   device's busy share during the largest population finetune;
6. K2 (quant_matmul) against its plain version on the card: qwen3-0.6b's 7
   weight shapes at M = 1, 8 (the decode batch) and 16 and a ragged shape,
   bf16 (the tensor-core body) and float32 (the CUDA-core body), within the
   bound stated beside the plain version; each case checks the body it took;
7. K5 (flash_attention) against its plain version on the card: the prefill
   shape, a ragged length, a window and a softcap case, bf16 (the wgmma
   body) and float32 (the CUDA-core body); bf16 at head_dim 64 and 256, GQA
   groups of 1, a window with a softcap; head_dim 192 at nemotron-4-340b's
   96/8 heads, T = 512 and 333, in both bodies; recurrentgemma-9b's MQA
   (16 query heads over one kv head, head_dim 256, window 2048 passed) and
   gemma2-2b's 8/4 heads (head_dim 256, window 4096 passed, softcap 50);
   whisper-base's encoder (T = S = 1500, 8/8 heads of 64) and the cross
   attention of phases 32-33 at prefill (T 1024) and decode (T 1) over
   1500 frames (8/8 heads of 64) and 1601 patches (32/8 heads of 128),
   bf16, non-causal; each case checks the body it took, and each windowed
   case past its window is also held against ``attend_local_banded``, the
   JAX package's banded path;
8. LM serving, prefill: ``make_prefill_step`` on qwen3-0.6b at full width
   (seeded random bf16 weights, 4 prompts of 1024 tokens), K5's launches
   counted (28, all through the wgmma body), the last-position logits held
   against the same step on K5's plain version;
9. LM serving, quantized decode: ``make_quant_serve_step`` on w8 weights,
   batch 8, 32 prompt tokens fed one at a time, then 32 greedy tokens,
   K2's launches counted (196 a step, all through its tensor-core body);
   the same token sequence teacher-forced
   through the kernel and through K2's plain version, logits compared per
   step; the device's busy share during decode;
10. LM serving, dense: ``ServeEngine`` (batch 4, max_len 256) answers 6
   requests of 16 prompt and 16 new tokens; tokens/s, and the busy share
   over one short wave;
11. K2's and K5's times on the card at those shapes (CUDA events, weights
   and inputs rotated through more than the L2 cache), their plain
   versions', one PyTorch library call's for the same function (a
   yardstick only), and their bounds; K5 and SDPA also as device times
   from CUDA graphs;
12. K6 (ssm_scan) against its plain version on the card: falcon-mamba-7b's
   prefill shape, a ragged T, a ragged d, a state of 4, states of 1, 3 and
   5 at T = 1, 63 and 65, bf16 and float32, within the bound stated beside
   the plain version;
13. K2 at falcon-mamba-7b's decode shapes (in_proj, x_proj, dt_proj on its
   float32 input, out_proj, the untied LM head) at M = 1, 8 and 16 against
   its plain version, each case's body checked;
14. falcon-mamba-7b prefill at full width (seeded random bf16 weights,
   7,272,665,088 parameters, 4 prompts of 1024 tokens), K6's launches
   counted (64), the last-position logits on 2 prompts of 256 tokens held
   against the same step on K6's plain version;
15. falcon-mamba-7b quantized decode: w8 weights, batch 8, 16 prompt tokens
   fed one at a time, then 16 greedy tokens, K2's launches counted (257 a
   step, 256 through its tensor-core body: dt_proj's x is float32), the same
   tokens teacher-forced through K2's plain version, the device's busy
   share;
16. falcon-mamba-7b dense ``ServeEngine`` (batch 4) answering 6 requests of
   16 prompt and 16 new tokens over the recurrent caches; tokens/s and the
   busy share;
17. K6's and K2's times at falcon-mamba-7b's shapes, their plain
   versions' and their bounds, K6's the largest of its bytes, its float32
   operations and its exp floor (its exps at the special-function units'
   rate and the card's highest SM clock), each printed; K2's and
   cuBLAS's per shape and for a decode step as device times from CUDA
   graphs, the eager loops' beside them;
18. K3 (clustered_matmul) against its plain version on the card: qwen3-0.6b's
   7 decode shapes at C = 16 with int8 indices, a ragged shape, int32
   indices (C = 16 and 300), M = 4096, bf16 and float32; indices C, C + 1
   and -1 (fault F2: weight 0), int8 and int32;
19. K4 (block_sparse_matmul) against its plain version: the same shapes at
   live shares 1.0, 0.5 and 0.1 in 128 x 128 tiles, (32, 32), (16, 16) and
   (8, 128) tiles, a skewed mask, M = 1 and 16, ragged M with a dead tile
   of non-zero weights and an all-dead column strip, M = 4096; each case's
   body checked;
20. qwen3-0.6b at full width (seeded random bf16 weights): each of its 196
   layer matrices clustered per input row at k = 16 by the port's
   ``cluster_per_input`` (indices stored int8) and block-pruned at sparsity
   0.5 in 128 x 128 tiles by its ``block_mask``; one decode step's products
   at M = 8 through K3, then through K4, the launches counted (196 each,
   K4's all through its tensor-core body), each of the 392 outputs held
   against its plain version;
21. K3's and K4's device times (CUDA graphs replayed between CUDA events)
   for that step and for single products at decode, at M = 4096 and at
   ``benchmarks/kernel_bench.py``'s shape, with K2's at the same shapes,
   their plain versions', cuBLAS's on the dense weight and their bounds;
   K4 at the gate's decode shape with a skewed mask beside a uniform one,
   and at 10% live against 100%;
22. K1 on approximated netlists against its plain version, the numpy oracle
   and the port's ``Simulator`` on the card, bit for bit: WhiteWine specs
   compiled by the port and approximated at five knob vectors (CSD drops
   up to 6, accumulator truncation at the clamp, comparator truncation
   that ties), exact and approximated netlists in one population, int64
   lanes, hand-built TRUNCs at the clamp of int32 (shift 31) and int64
   (shift 61) lanes, batches that are not a tile multiple; the tied
   comparator inputs counted (> 0); K1's device time on the approximated
   population beside the exact one of the same specs;
23. the search with the approximation genes through its entry point
   (``paper.run(..., approx=True)``, WhiteWine, population 8, 3
   generations, 60 epochs) on CUDA, K1's launches split into packed exact
   launches and one per approximated candidate; then ``fit_budget`` on the
   chosen point at 1% of its logit range, its measured max logit error
   (the ``Simulator`` on the card) held under the proven bound;
24. the Fig. 1 sweeps (``paper.fig1(["whitewine"], epochs=60)``, 6 + 5 + 5
   specs and the baseline) on CUDA, each technique's gain at <=5% loss;
25. the fault-tolerant island search (``repro_torch.search``) on CUDA:
   WhiteWine (11-10-7, 60 epochs), 2 islands of population 8, 4 rounds,
   migration every 2 rounds with 1 migrant, a checkpoint every round, the
   batch evaluator on CUDA with tracing on. Run A uninterrupted; run B,
   with its own cache, preempted after its second round and resumed by a
   new runtime; run C with island 1 killed in round 1 and one spec failing
   every attempt. Checked: B's front, objectives and evaluations byte-equal
   to A's, with no spec finetuned again after the resume; C's survivor
   finishes and the failing spec is quarantined on its result; every K1
   launch took the shared-memory body; on A's front the netlist-exact
   accuracy equals ``integer_forward``'s; the port's report of A's trace
   lists the finetune and K1 with CUDA-event times, K1's nvcc build as its
   one compile, and no recompile. Printed: each run's seconds, checkpoint
   write ms and bytes, K1's launches, the finetune's share of A's wall
   time and the report.

26. the backward kernels: K5's (flash_attention_bwd) against its plain
   version on the card at qwen3-0.6b's training shape (B 4, T 1024, 16/8
   heads of 128, bf16), head_dim 192 at 96/8 heads, head_dim 256 with a
   window and a softcap (gemma2's) and 16 heads of 256 on one KV head
   (the last three through the two-warpgroup wgmma body, each with its
   device time against its bound), and two small float32 cases (head_dim
   64 and 256, the CUDA-core body) also against autograd of the plain
   forward; the forward's lse against its plain
   version; the gradients through autograd equal the kernel's; K6's
   (ssm_scan_bwd) at falcon-mamba-7b's width (B 2, T 1024, d 8192, N 16)
   against its plain version, a second call equal to the bit; their times
   over input sets rotated past the L2 (device times from CUDA graphs),
   plain versions' times and bounds, K5's three kernels' device times from
   torch.profiler, SDPA's backward alone timed as K5's is, K5's forward
   plus backward through autograd beside F.scaled_dot_product_attention's,
   and K6's forward at the training shape with and without the states it
   keeps for its backward;
27. training: qwen3-0.6b at full width and depth (596,049,920 seeded
   parameters, B 4, T 1024, AdamW, remat): one gradient through the
   kernels against the same through K5's plain version (global norm and
   each leaf's norm within the stated bounds; 56 K5 forward launches, all
   through the wgmma body, and 28 backward launches); 4 steps through
   ``repro_torch.launch.train`` (a donated step: the state updated in
   place) with the launches counted, the step's seconds, tokens/s, peak
   memory and the device's busy share; a run
   preempted after 2 steps (as its SIGTERM handler does: finish the step,
   checkpoint, stop), a new run resumed from it for 2 more, its losses within
   rtol 2e-3 of the uninterrupted run's (and whether bit-equal); one step
   with ``--qat-bits 8``; then falcon-mamba-7b at full width with 4 of its
   64 layers (its 7.27 B parameters with gradients and AdamW state pass
   the card's 80 GB), 3 steps at B 2, T 1024, K6's backward 4 times a step;
28. gemma2-2b at full width and depth (seeded random bf16 weights):
   ``make_prefill_step`` on 4 x 1024 tokens, K5's 26 launches counted by
   window (13 windowed, 13 global) and body, the logits held against K5's
   plain version; the w8 decode at batch 8 (16 prompt + 16 greedy steps),
   K2's launches counted (7 a layer, 182 a step, all through its
   tensor-core body), teacher-forced against K2's plain version, the busy
   share; then one repeat (local, global) at full width decodes 4096 + 64
   tokens one at a time at batch 2 through the ring buffer, its logits at
   three positions past the window held against the last-position logits
   of a cache-free prefill over the same tokens (K5 with its window);
29. recurrentgemma-9b at full width and depth (38 layers, 26 RG-LRU and
   12 local): the prefill as in 28 (K5 12 launches, all windowed), the
   RG-LRU scan's share of it, the w8 decode (K2 240 a step: 6 a
   recurrent layer, 7 a local one), the dense ``ServeEngine``, and the
   ring wrap on one repeat (rec, rec, local) past its 2048 positions,
   which also holds RG-LRU's step-by-step state against its scan;
30. phi3.5-moe-42b-a6.6b at full width with 4 of its 32 layers (all 32 are
   84 GB in bf16): the prefill (K5 4 launches), the logits held against
   K5's plain version with the kernel run's routing replayed (the choices
   the plain run would flip counted), the dropped-token share at capacity
   factor 1.25, the router's aux loss (finite, > 0), the dense engine;
31. deepseek-v2-236b at full width with its dense layer 0 and 3 of its 59
   MoE layers (13,302,912,000 parameters; all 60 are about 440 GiB in
   bf16): the prefill through MLA (K5 4 launches at head_dim 192 with v
   padded from 128), the logits against K5's plain version with the
   routing replayed; K5 at MLA's shape through ``attend`` and alone, SDPA
   on v at 128 beside it; MLA's absorbed decode against the last position
   of a prefill over the same tokens (layer 0 alone); the dense engine;
   the w8 decode (K2 33 a step; the bf16 weights freed first, as the step
   dequantizes the expert stacks);
32. whisper-base at full width and depth, every ``cross_gate`` set to 0.5
   (0 at init would drop the cross sublayer): the encoder over 4 x 1500
   seeded frames (K5 6 launches, non-causal) against K5's plain version; the
   prefill over them (K5 18: 6 encoder, 6 causal, 6 cross over the
   frames; each non-causal launch also held element by element against
   K5's plain version on its inputs); over the encoder's output for 8
   requests, the dense decode teacher-forced for 32 steps (K5 6 a step for
   the cross attention at T = 1, each launch held element by element, the
   logits against the same steps on K5's plain version), the dense engine
   and the w8 decode (K2 61 a step, K5 6 a step; the 12 cross K and V
   projections at M = 8 x 1500 through K2's large-M body, the other 49 at
   M = 8 through its decode body), and the share of the w8 step the cross
   projections take, as in 33;
33. llama-3.2-vision-11b at full width and depth (40 layers, 8 cross, the
   gates at 0.5): the prefill over 4 x 1601 seeded patches (K5 48: 40
   causal, 8 cross, the cross launches held as in 32), the dense decode as
   in 32 (K5 8 a step), the dense engine, the w8 decode (K2 313 a step, K5
   8; the 16 cross K and V projections at M = 8 x 1601 through K2's
   large-M body, every other launch through its decode body), and the
   share of the w8 step that the cross projections take (made again at
   every step, as the JAX package does; their launches checked to take
   the large-M body);
34. training the hybrid, MoE, MLA, whisper and vision families at full
   width: first what phases 1-33 leave allocated (the CUDA tensors Python
   still reaches and their holders, then cuBLAS's workspaces released);
   then gemma2-2b whole at 1 x 8192 (past its 4096 window),
   recurrentgemma-9b with 2 of its 12 (rec, rec, local) periods at 1 x
   4096, phi3.5-moe with 2 of 32 layers at 4 x 1024, deepseek-v2 with its
   dense layer and 1 of 59 MoE layers at 1 x 1024, whisper-base whole and
   llama-3.2-vision with 2 of 8 periods at 4 x 1024 over seeded frames or
   patches (every ``cross_gate`` at 0.5): one gradient through the
   kernels against one through K5's plain version (the global norm, each
   leaf's norm and each leaf's relative L2 within ``TRAIN_BOUNDS``, about
   4x the H100's readings; K5's forward and backward launches
   and bodies counted, the MoE routing replayed, a second kernel gradient
   compared to the bit for the MoE families), 3 donated train steps with
   finite losses, their seconds, tokens/s, peak memory and busy share,
   the RG-LRU scan's share of a recurrentgemma-9b step, and K5's backward
   at each family's attention shapes, held element by element against
   its plain version, its device time from a CUDA graph against its
   bound and SDPA's backward (every backward launch of the six families
   through the wgmma body, at head_dim 192 and 256 its two-warpgroup
   kernels); then whisper-base through
   ``launch.train`` (zero frames) preempted after 2 steps and resumed,
   its losses bit-equal to an uninterrupted run's.
   Phases 28-30 run in ``hybrid_serving``, 31-33 in ``mla_cross_serving``,
   34 in ``family_training``, each callable alone after K2 and K5 (and,
   for 34, K5's backward) are built.
35. the LM planning path's dry-run (`launch.dryrun.run_cell`) of every arch
   x shape of the registry but `SWEEP_LEFT_OUT` on the meta device: each
   cell ok or skipped by `shape_applicable`, its depth fit equal to the
   direct count, the H100 roofline's t_step and dominant term, the
   arguments' and temporaries' GiB against the card's 80 GB;
36. the dry-run held against the card at full width in `PLAN_CELLS`
   (qwen3-0.6b train_4k at 1 x 4096, all 28 layers, K5 forward and
   backward; qwen3-0.6b decode_32k, w8, batch 8, K2; falcon-mamba-7b
   prefill_32k at batch 1, K6; falcon-mamba-7b decode_32k, w4, batch 8,
   K2's int4 bodies): the same `roofline.analysis.count_step`
   over the real step, its FLOPs and kernel records equal to the meta
   count, the peak within `PEAK_REL`/`PEAK_ABS` of the predicted
   arguments + temporaries, the median step time beside t_step, then one
   more step under a `KernelAudit`;
37. the four LM examples through their entry points: `lm_compression`
   (NSGA-II priced by `core.gpu_cost` on the H100; its Pareto front and
   projected decode speed-up), `quickstart` (K1; the area gains),
   `serve_demo` (K5, K6, K2; the tokens generated), `train_lm_100m
   --steps 30` (the loss going down), under a `KernelAudit`;
38. `dist.grad_compression` over qwen3-0.6b's real gradient trees (drawn
   under a `KernelAudit`): every leaf within half a step, the
   error-feedback sum tracking the true sum over 4 rounds.
   A `KernelAudit` holds the first launch of each distinct call of K2, K5,
   K5's backward, K6 and K6's backward (shapes, dtype, mask) element by
   element against the plain version on that launch's own inputs, under
   the tolerances of the earlier phases, and checks the body each K5 and
   K2 launch took; every kind of kernel a phase launches must have been
   held so (bf16 at head_dim 32 on K5's CUDA-core body in lm_compression,
   float32 at head_dim 64 in train_lm_100m, K5 and its backward at 1 x
   4096, K6 at 1 x 32768, the gradients at 2 x 512).
   Phases 35-38 run in ``planning_sweep``, ``planning_cells``,
   ``planning_examples`` and ``gradient_compression``.
39. K2's packed-int4 bodies (w4 payloads stored two weights a byte) against
   the plain version on the same payload: qwen3-0.6b's 7 and
   falcon-mamba-7b's 5 decode shapes at M = 1, 8 and 16, and a ragged one
   (N odd, ceil(N/2) no multiple of 16, K no multiple of 16), bf16 x (the
   mma path) and float32 x (the CUDA cores), each case's body checked;
   their device times at M = 8 from CUDA graphs for a qwen3-0.6b layer
   and a falcon-mamba-7b step, beside the int8 body's on the same values,
   the plain version's, torch.matmul's on the dequantized weight and the
   byte bound at packed bytes;
40. qwen3-0.6b w4 decode at full width as phase 9 (596,049,920 seeded bf16
   parameters, batch 8, 32 prompt + 32 greedy steps): the w8 and w4
   payloads on the card by ``nbytes`` and by ``memory_allocated``, w4
   half of w8 up to the odd-width padding nibbles; K2 196 launches a
   step, all through the int4 body and its mma path; the same tokens
   teacher-forced through K2's plain version within phase 9's bound; ms a
   step and the busy share;
41. falcon-mamba-7b w4 decode at full width as phase 15 (batch 8, 16 + 16
   steps): its payloads as in 40; K2 257 a step, all through the int4
   body, 256 on the mma path (dt_proj's x is float32); teacher-forced
   within phase 15's bound; ms a step and the busy share.
   Phases 39-41 run in ``w4_serving``, after phase 17.
42. K2's large-M body (``wgmma``, bf16 x; ``wide_products``, after phase
   41): both bodies through their C entry points at M = 16 to 1024 at
   qwen3-0.6b's gate/up (K 1024, N 3072) and the vision cross
   projection's (K 4096, N 1024), int8 and packed int4, device times from
   CUDA graphs over weight sets past the L2, and the smallest M of the
   sweep from which the large-M body is no slower at both shapes beside
   the wrapper's threshold; then the vision and whisper cross K/V shapes
   (M 12808, K 4096, N 1024; M 12000, K = N = 512), int8 and int4:
   through the wrapper, one launch of the large-M body, within
   ``quant_matmul_tolerance`` of the plain version and equal to the bit
   on a rerun; an x view off a 16-byte boundary through the decode body;
   device times beside the other row count a block, the decode body,
   cuBLAS on the dequantized weight, the plain version and the bound; and
   at two shapes of 16384 rows, where rounds of blocks hardly matter, a
   block's time a row of x at 160 rows against 128 (``ops.ROW_COST``).
   The M = 8 decode phases (9, 15, 28-31, 39-41) check that no launch
   took it.

Each phase prints its seconds and the device's peak allocated memory.
Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
# exp2 results a clock on one SM at compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
EXP2_PER_CLOCK_PER_SM = 16


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def device_busy(fn, wall_s=None, cpu=True):
    """(wall s, device busy s, kernels): ``fn`` once on the host clock
    (unless its ``wall_s`` is known), then once under ``torch.profiler``,
    whose CUDA kernel times are summed (busy share = busy / wall).
    ``cpu=False`` records the device's activity alone, which a step of
    200k launches needs (recording every host op of it takes minutes);
    where the profiler then sees no kernel, it records both."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if wall_s is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    if busy_s == 0 and not cpu:
        return device_busy(fn, wall_s)
    check(busy_s > 0, "the profiler saw no device time")
    return wall_s, busy_s, sum(e.count for e in events)


def kernel_ms_by_name(fn, reps: int, names) -> dict:
    """Device ms of one launch of the kernels whose names contain each of
    ``names``, for a ``fn`` that launches each once: ``fn`` run ``reps``
    times under ``torch.profiler`` after one warm-up call, each name's CUDA
    kernel time over the launches the profiler recorded (it may record
    fewer than were made), None for a name it recorded no launch of."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in e.key:
                total[n] += e.self_device_time_total / 1e3
                count[n] += e.count
    return {n: total[n] / count[n] if count[n] else None for n in names}


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
# K3's and K4's single-product timings (M, K, N, K4's live shares): the
# gate/up product of qwen3-0.6b at decode and at M = 4096, and the shape that
# benchmarks/kernel_bench.py derives rooflines for
PER_PRODUCT_SHAPES = {
    "qwen3_gate_decode": (8, 1024, 3072, (1.0, 0.5, 0.1, "skewed")),
    "qwen3_gate_m4096": (4096, 1024, 3072, (0.5,)),
    "kernel_bench": (16, 4096, 14336, (0.5,)),
}
# the TPU functions K3 and K4 replace: where each reaches pl.pallas_call
REPLACES = {
    "clustered_matmul": "src/repro/kernels/clustered_matmul/kernel.py:46",
    "block_sparse_matmul":
        "src/repro/kernels/block_sparse_matmul/kernel.py:42",
}
# phase 26's backward cases (B, T, H, KV, hd, window, softcap, dtype):
# qwen3-0.6b's training shape and head_dim 64 with GQA 4, a window, a
# softcap and a ragged T (the one-warpgroup wgmma body); head_dim 192 at
# nemotron-4-340b's 96/8 heads, head_dim 256 with a window and gemma2's
# softcap, and 16 heads of 256 on one KV head with a window and a ragged
# T (the head split) (the two-warpgroup wgmma body); two small float32
# cases, at head_dim 64 and 256 (the CUDA-core body)
BWD_CASES = {
    "qwen3_train": (4, 1024, 16, 8, 128, 0, 0.0, "bfloat16"),
    "hd64_g4_window_softcap_ragged": (2, 1000, 16, 4, 64, 128, 30.0,
                                      "bfloat16"),
    "hd192_96_8": (1, 512, 96, 8, 192, 0, 0.0, "bfloat16"),
    "hd256_window_softcap": (1, 1024, 8, 4, 256, 256, 50.0, "bfloat16"),
    "hd256_g16_kv1_window_ragged": (1, 2000, 16, 1, 256, 1024, 0.0,
                                    "bfloat16"),
    "f32_small_ragged": (2, 77, 4, 2, 64, 0, 30.0, "float32"),
    "f32_hd256_small": (1, 130, 4, 2, 256, 0, 0.0, "float32"),
}
# phase 27: qwen3-0.6b's training batch and length, its parameters; and
# falcon-mamba-7b's batch, length and the layers kept of its 64
QWEN3_TRAIN = (4, 1024)
QWEN3_PARAMS = 596049920
FALCON_TRAIN = (2, 1024, 4)
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


# one side stream for every graph timing: cuBLAS keeps a workspace for each
# stream it has run on, allocated through PyTorch's allocator
_STREAMS = {}


def _graph_ms(fn, sets, reps: int, stream=None) -> float:
    """Device time of one ``fn(*sets[i % len(sets)])``, i < reps: the calls
    are captured once in a CUDA graph, which is replayed between CUDA
    events, so the host's cost of each call (a wrapper's checks, the
    launch) is left out. The sets rotate as in `_rotating_ms`. With
    ``stream``, the warm-up and the capture run on it: a backward through
    autograd runs on its forward's stream, so the forward must have run
    there."""
    import torch
    if stream is None and "side" not in _STREAMS:
        _STREAMS["side"] = torch.cuda.Stream()
    side = stream or _STREAMS["side"]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # builds, allocations, library handles
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, **({"stream": stream} if stream else {})):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
        shapes = [(M,) + kn for M in (1, 8, 16)
                  for kn in QWEN3_QMM.values()] + [(5, 1000, 3000)]
        for (M, K, N) in shapes:
            for dname, dt in dtypes.items():
                x = torch.randn((M, K), generator=gen, device=dev).to(dt)
                w = torch.randint(-127, 128, (K, N), generator=gen,
                                  device=dev, dtype=torch.int8)
                s = (torch.rand((N,), generator=gen, device=dev) + 0.1) * 0.01
                reset_launches()
                got = QM.quant_matmul(x, w, s)
                torch.cuda.synchronize()
                check(LAUNCHES["quant_matmul_mma"] == int(dname == "bf16"),
                      f"quant_matmul {(M, K, N)} {dname} took the wrong body")
                ref = QM.quant_matmul_ref(x, w, s)
                tol = QM.quant_matmul_tolerance(x, w, s, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                qmm_err = max(qmm_err, err)
                print(f"[6] quant_matmul M={M} K={K} N={N} {dname} "
                      f"({'mma' if dname == 'bf16' else 'cuda-core'} body): "
                      f"max abs "
                      f"err {err:.3e}, tolerance at that element "
                      f"{float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"within={bool((diff <= tol).all())}")
                check(bool((diff <= tol).all()),
                      f"quant_matmul disagrees at {(M, K, N)} {dname}")

    # -- 7. K5 against its plain version ---------------------------------
    # bf16 at head_dim 64, 128, 192 and 256 goes through the wgmma body,
    # float32 through the CUDA-core body; each case checks which body it took
    fa_err, fa_share = 0.0, 0.0
    with Phase(7, "flash_attention vs plain"):
        cases = {  # (B, T, S, H, KV, hd, causal, window, softcap, dtypes)
            "prefill": (4, 1024, 1024, 16, 8, 128, True, 0, 0.0, dtypes),
            "ragged_t_1000": (2, 1000, 1000, 16, 8, 128, True, 0, 0.0,
                              dtypes),
            "window_256": (1, 700, 700, 16, 8, 128, True, 256, 0.0, dtypes),
            "softcap_30": (2, 300, 300, 16, 8, 128, True, 0, 30.0, dtypes),
            "non_causal_s_333": (2, 200, 333, 16, 8, 128, False, 0, 0.0,
                                 dtypes),
            "hd64_gqa1": (2, 1000, 1000, 8, 8, 64, True, 0, 0.0,
                          {"bf16": torch.bfloat16}),
            "hd256_gqa2_softcap_50": (1, 1000, 1000, 8, 4, 256, True, 0,
                                      50.0, {"bf16": torch.bfloat16}),
            "hd256_gqa1_ragged_77": (3, 77, 77, 4, 4, 256, True, 0, 0.0,
                                     {"bf16": torch.bfloat16}),
            "window_128_softcap_30_gqa1": (1, 900, 900, 8, 8, 128, True, 128,
                                           30.0, {"bf16": torch.bfloat16}),
            # nemotron-4-340b's head_dim and head counts (fault F3)
            "hd192_nemotron": (1, 512, 512, 96, 8, 192, True, 0, 0.0,
                               dtypes),
            "hd192_ragged_333": (1, 333, 333, 96, 8, 192, True, 0, 0.0,
                                 dtypes),
            # recurrentgemma-9b's local layers: MQA, 16 query heads over one
            # kv head, window 2048 passed; gemma2-2b's: 8/4 heads, window
            # 4096 passed, softcap 50 (phases 28 and 29)
            "hd256_g16_window_2048": (1, 2500, 2500, 16, 1, 256, True, 2048,
                                      0.0, {"bf16": torch.bfloat16}),
            "hd256_gemma2_window_4096_softcap_50": (
                1, 4200, 4200, 8, 4, 256, True, 4096, 50.0,
                {"bf16": torch.bfloat16}),
            # phases 32 and 33, non-causal: whisper-base's encoder (8/8
            # heads of 64 over 1500 frames), and the cross attention at
            # prefill (T 1024, batch 4) and at decode (T 1, batch 8) over
            # whisper's 1500 frames and llama-3.2-vision's 1601 patches
            # (32/8 heads of 128)
            "whisper_encoder_t_s_1500": (4, 1500, 1500, 8, 8, 64, False, 0,
                                         0.0, {"bf16": torch.bfloat16}),
            "whisper_cross_t_1024_s_1500": (4, 1024, 1500, 8, 8, 64, False,
                                            0, 0.0, {"bf16": torch.bfloat16}),
            "vision_cross_t_1024_s_1601": (4, 1024, 1601, 32, 8, 128, False,
                                           0, 0.0, {"bf16": torch.bfloat16}),
            "whisper_cross_t_1_s_1500": (8, 1, 1500, 8, 8, 64, False, 0, 0.0,
                                         {"bf16": torch.bfloat16}),
            "vision_cross_t_1_s_1601": (8, 1, 1601, 32, 8, 128, False, 0,
                                        0.0, {"bf16": torch.bfloat16}),
        }
        for name, (B, Tq, S, H, KV, hd, causal, window, cap, dts) in \
                cases.items():
            for dname, dt in dts.items():
                q = torch.randn((B, Tq, H, hd), generator=gen,
                                device=dev).to(dt)
                k = torch.randn((B, S, KV, hd), generator=gen,
                                device=dev).to(dt)
                v = torch.randn((B, S, KV, hd), generator=gen,
                                device=dev).to(dt)
                kw = dict(causal=causal, window=window, softcap=cap)
                reset_launches()
                got = FA.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                body = ("wgmma" if LAUNCHES["flash_attention_wgmma"]
                        else "cuda-core")
                check(body == ("wgmma" if dt == torch.bfloat16
                               else "cuda-core"),
                      f"flash_attention {name} {dname} took the {body} body")
                ref = FA.flash_attention_plain(q, k, v, **kw)
                err, share, ok = _within(
                    got, ref, FA.flash_attention_bound(q, k, v, ref, **kw))
                fa_err, fa_share = max(fa_err, err), max(fa_share, share)
                print(f"[7] flash_attention {name} B={B} T={Tq} S={S} H={H} "
                      f"KV={KV} hd={hd} {dname}, {body} body: max abs err "
                      f"{err:.3e}, largest share of the bound {share:.3e}, "
                      f"within={ok}")
                check(ok, f"flash_attention disagrees on {name} {dname}")
                if window and Tq > window:
                    # the JAX package's banded path, the windowed yardstick
                    banded = A.attend_local_banded(q, k, v, window=window,
                                                   softcap=cap)
                    err, share, ok = _within(got, banded,
                                             FA.flash_attention_bound(
                                                 q, k, v, banded, **kw))
                    print(f"[7] flash_attention {name} {dname} vs "
                          f"attend_local_banded: max abs err {err:.3e}, "
                          f"largest share of the bound {share:.3e}, "
                          f"within={ok}")
                    check(ok, f"flash_attention disagrees with the banded "
                          f"path on {name}")
                    del banded
                del q, k, v, got, ref

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
        k5_wgmma = launches["flash_attention_wgmma"]
        check(k5_wgmma == k5_launches,
              f"{k5_wgmma} of prefill's {k5_launches} flash_attention "
              f"launches took the wgmma body")
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
        check(launches["quant_matmul_mma"] == k2_launches
              and launches["quant_matmul_wgmma"] == 0,
              f"{launches['quant_matmul_mma']} of {k2_launches} quant_matmul "
              f"launches took the decode body's tensor-core path, "
              f"{launches['quant_matmul_wgmma']} the large-M body")
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
        # device times from CUDA graphs (at ~0.07 ms a call an eager loop
        # is near the host's floor), the eager times beside them
        fa_ms = _graph_ms(FA.flash_attention, sets, reps=30)
        fa_eager_ms = _rotating_ms(FA.flash_attention, sets, reps=30)
        fa_plain_ms = _rotating_ms(FA.flash_attention_plain, sets, reps=6)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        check(_rel(sdpa(*sets[0]).transpose(1, 2).float(),
                   FA.flash_attention(*sets[0]).float()) < 1e-2,
              "SDPA yardstick computes another function")
        fa_lib_ms = _graph_ms(sdpa, sets, reps=30)
        fa_lib_eager_ms = _rotating_ms(sdpa, sets, reps=30)
        # 4 hd flops a visible (t, s) pair a head, q k v o moved once: the
        # wrapper's own counts
        from repro_torch.kernels.flash_attention.ops import cost as fa_cost
        fa_flops, fa_bytes = fa_cost(B, Tq, Tq, H, KV, hd, 2)
        fa_bytes_ms = fa_bytes / HBM_BYTES_PER_S * 1e3
        fa_ops_ms = fa_flops / BF16_TENSOR_FLOPS * 1e3
        print(f"[11] {card}: flash_attention B={B} T=S={Tq} H={H} KV={KV} "
              f"hd={hd} causal bf16, wgmma body: kernel {fa_ms:.4f} ms on "
              f"the device (eager {fa_eager_ms:.4f} ms), plain "
              f"{fa_plain_ms:.4f} ms, SDPA {fa_lib_ms:.4f} ms on the device "
              f"(eager {fa_lib_eager_ms:.4f} ms), bound "
              f"{max(fa_bytes_ms, fa_ops_ms):.5f} ms ({fa_flops} flops, "
              f"{fa_bytes} bytes); {fa_flops / fa_ms / 1e9:.1f} TFLOP/s, "
              f"{fa_ms / max(fa_bytes_ms, fa_ops_ms):.2f}x the bound")

    return [
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "body": "decode body: bf16 x on mma.sync.m16n8k16 (tensor "
                 "cores) on int8 dequantized in registers, float32 x on "
                 "the CUDA cores, split-K over a thread-block cluster, "
                 "staged by cp.async; packed 4-bit payloads: the int4 "
                 "bodies (int4_body); bf16 x from wgmma_min_m rows: the "
                 "large-M body (wgmma_body)",
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
         "body": "wgmma (bf16, head_dim 64/128/256; the CUDA-core body "
                 "serves float32 and head_dim 16/32)",
         "launches": k5_launches,
         "launches_wgmma_body": k5_wgmma,
         "max_abs_err": fa_err, "largest_share_of_bound": fa_share,
         "tolerance": "flash_attention_tolerance (2 S eps32 max|v| "
                      "+ 2^-7 |o| + 2^-8 softmax|v| for bf16)",
         "shapes": "prefill B=4 T=S=1024 H=16 KV=8 hd=128 causal bf16",
         "ms": fa_ms, "eager_ms": fa_eager_ms, "plain_ms": fa_plain_ms,
         "bound_ms": max(fa_bytes_ms, fa_ops_ms),
         "bound_by": "bytes" if fa_bytes_ms >= fa_ops_ms else "operations",
         "library_ms": fa_lib_ms, "library_eager_ms": fa_lib_eager_ms,
         "library": "F.scaled_dot_product_attention, device time"},
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


def qmm_bound_ms(M, K, N, x_bytes, packed=False):
    """(bound ms, "bytes" or "operations") of y = x @ dequant(w): x read,
    the weight payload (int8, or ``packed`` 4-bit at ceil(N/2) bytes a
    row) and scales read, y written once; 2MKN operations at the bf16
    tensor-core rate (float32 x: the TF32 rate, the most a float32 product
    could reach). The counts are the wrapper's own (`cost`), the ones its
    profiled dispatches record."""
    from repro_torch.kernels.quant_matmul.ops import cost
    ops, nbytes = cost(M, K, N, x_bytes, packed)
    rate = BF16_TENSOR_FLOPS if x_bytes == 2 else TF32_TENSOR_FLOPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
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
        # states the lanes split unevenly, short and ragged chunks, a d no
        # multiple of the block's channels (odd: one element a copy)
        cases.update({f"state_{n}_t{t}": (2, t, 1000 + 16 * n + t, n)
                      for n in (1, 3, 5) for t in (1, 63, 65)})
        for name, (B, Tq, dd, n) in cases.items():
            for dname, dt in dtypes.items():
                args = ssm_inputs(gen, B, Tq, dd, n, dt, dev)
                ref = SS.ssm_scan_ref(*args)
                tol = SS.ssm_scan_tolerance(*args, ref)
                got = SS.ssm_scan(*args)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                ssm_err = max(ssm_err, err)
                ok = bool((diff <= tol).all())
                print(f"[12] ssm_scan {name} B={B} T={Tq} d={dd} N={n} "
                      f"{dname}: max abs err {err:.3e}, tolerance at that "
                      f"element {float(tol.flatten()[diff.argmax()]):.3e}, "
                      f"largest share of the tolerance "
                      f"{float((diff / tol.clamp_min(1e-30)).max()):.3f}, "
                      f"within={ok}")
                check(ok, f"ssm_scan disagrees on {name} {dname}")
                del args, ref, tol, got, diff

    # -- 13. K2 at this model's shapes -----------------------------------
    qmm_err = 0.0
    with Phase(13, "quant_matmul vs plain, falcon-mamba-7b shapes"):
        for name, (K, Nn, xname) in shapes.items():
            for M, dname in [(M, d) for M in (1, 8, 16)
                             for d in sorted({xname, "f32"})]:
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    dtypes[dname])
                w = torch.randint(-127, 128, (K, Nn), generator=gen,
                                  device=dev, dtype=torch.int8)
                sc = (torch.rand((Nn,), generator=gen, device=dev) + 0.1) \
                    * 0.01
                reset_launches()
                got = QM.quant_matmul(x, w, sc)
                torch.cuda.synchronize()
                check(LAUNCHES["quant_matmul_mma"] == int(dname == "bf16"),
                      f"quant_matmul {name} M={M} {dname} took the wrong "
                      f"body")
                ref = QM.quant_matmul_ref(x, w, sc)
                tol = QM.quant_matmul_tolerance(x, w, sc, ref)
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                qmm_err = max(qmm_err, err)
                ok = bool((diff <= tol).all())
                print(f"[13] quant_matmul {name} M={M} K={K} N={Nn} {dname}: "
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
        # every product but dt_proj (float32 x) takes the tensor-core body
        check(launches["quant_matmul_mma"] == (per_step - layers) * (P + G)
              and launches["quant_matmul_wgmma"] == 0,
              f"{launches['quant_matmul_mma']} quant_matmul launches took "
              f"the decode body's tensor-core path, not "
              f"{(per_step - layers) * (P + G)} "
              f"({launches['quant_matmul_wgmma']} the large-M body)")
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
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ssm_ms = _rotating_ms(SS.ssm_scan, sets, reps=60)
        ssm_plain_ms = _rotating_ms(SS.ssm_scan_ref, sets, reps=3)
        # the inputs read and y (bf16) written once; N state updates of 5
        # operations (dt A, da h, dt u, its product with B, the add) and N
        # multiply-adds into y per (b, t, c), plus D u, on the CUDA cores:
        # the wrapper's own counts
        from repro_torch.kernels.ssm_scan.ops import cost as ssm_cost
        ssm_ops, ssm_bytes = ssm_cost(B, Tq, di, N, 2)
        check(ssm_bytes == sum(a.numel() * a.element_size()
                               for a in sets[0]) + B * Tq * di * 2,
              "ssm_scan's byte count differs from its inputs and output")
        ssm_bytes_ms = ssm_bytes / HBM_BYTES_PER_S * 1e3
        ssm_ops_ms = ssm_ops / SCALAR_OPS_PER_S * 1e3
        # and N exps per (b, t, c) on the special-function units: 16 exp2
        # results a clock per SM at compute capability 9.0 (CUDA C++
        # Programming Guide, throughput of native arithmetic instructions),
        # at the card's highest SM clock; operations too, at their own rate
        clock_hz = max_sm_clock_hz()
        ssm_exps = B * Tq * di * N
        exp_floor_ms = ssm_exps / (EXP2_PER_CLOCK_PER_SM * sms * clock_hz) \
            * 1e3
        ssm_bound = max(ssm_bytes_ms, ssm_ops_ms, exp_floor_ms)
        ssm_bound_by = "bytes" if ssm_bound == ssm_bytes_ms else "operations"
        print(f"[17] {card}: ssm_scan B={B} T={Tq} d={di} N={N} bf16: "
              f"kernel {ssm_ms:.4f} ms, plain {ssm_plain_ms:.4f} ms, bound "
              f"{ssm_bound:.5f} ms, the largest of: {ssm_bytes} bytes "
              f"{ssm_bytes_ms:.5f} ms; {ssm_ops} float32 operations "
              f"{ssm_ops_ms:.5f} ms; exp floor {exp_floor_ms:.5f} ms "
              f"({ssm_exps} exps at {EXP2_PER_CLOCK_PER_SM} a clock on {sms} "
              f"SMs at {clock_hz / 1e9:.3f} GHz); {ssm_ms / ssm_bound:.2f}x "
              f"the bound, {ssm_ms / ssm_bytes_ms:.2f}x the bytes alone")
        del sets

        # device times from CUDA graphs (`_graph_ms`: at a few us a product
        # an eager loop reads the host's cost of each call), eager beside
        k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, eager_ms=0.0,
                  eager_plain_ms=0.0, eager_library_ms=0.0, bound=0.0)
        M = 8
        for name, (K, Nn, xname) in shapes.items():
            xdt = dtypes[xname]
            copies = max(2, math.ceil(120e6 / (K * Nn)))
            x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
            wsets = [(x, torch.randint(-127, 128, (K, Nn), generator=gen,
                                       device=dev, dtype=torch.int8),
                      torch.rand((Nn,), generator=gen, device=dev) * 0.01)
                     for _ in range(copies)]
            deq = [(x, L.dequantize({"q": w, "scale": sc}, xdt))
                   for _, w, sc in wsets]
            t = dict(
                ms=_graph_ms(QM.quant_matmul, wsets, reps=4 * copies),
                plain_ms=_graph_ms(QM.quant_matmul_ref, wsets,
                                   reps=max(2, copies)),
                library_ms=_graph_ms(torch.matmul, deq, reps=4 * copies),
                eager_ms=_rotating_ms(QM.quant_matmul, wsets,
                                      reps=4 * copies),
                eager_plain_ms=_rotating_ms(QM.quant_matmul_ref, wsets,
                                            reps=copies),
                eager_library_ms=_rotating_ms(torch.matmul, deq,
                                              reps=4 * copies))
            t["bound"], by = qmm_bound_ms(M, K, Nn, x.element_size())
            print(f"[17] {card}: quant_matmul {name} M={M} K={K} N={Nn} "
                  f"{xname}: kernel {t['ms']:.4f} ms on the device (eager "
                  f"{t['eager_ms']:.4f}), plain {t['plain_ms']:.4f} "
                  f"(eager {t['eager_plain_ms']:.4f}), torch.matmul on the "
                  f"dequantized {xname} weight {t['library_ms']:.4f} (eager "
                  f"{t['eager_library_ms']:.4f}), bound {t['bound']:.5f} ms "
                  f"({by}); {t['ms'] / t['bound']:.1f}x the bound")
            weight = layers if name != "lm_head" else 1
            for key, val in t.items():
                k2[key] += weight * val
            del wsets, deq
        print(f"[17] {card}: quant_matmul, one falcon-mamba-7b decode step "
              f"({layers} x 4 products + LM head) on the device: kernel "
              f"{k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, library "
              f"{k2['library_ms']:.3f} ms, bound {k2['bound']:.4f} ms; "
              f"eager: kernel {k2['eager_ms']:.3f} ms, plain "
              f"{k2['eager_plain_ms']:.3f} ms, library "
              f"{k2['eager_library_ms']:.3f} ms")

    ssm_entry = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "body": "CUDA cores: a channel's state split over 4 lanes with a "
                "shuffle tree for y, time in chunks of 32 steps through a "
                "cp.async ring, ex2.approx.ftz",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:51",
        "launches": k6_launches, "max_abs_err": ssm_err,
        "tolerance": "ssm_scan_tolerance (16 eps32 sum|C| E + 2 (N+2) "
                     "eps32 (sum|C h| + |D u|) + 2^-7 |y| for bf16)",
        "shapes": f"prefill B={B} T={Tq} d={di} N={N} bf16 u, float32 dt",
        "ms": ssm_ms, "plain_ms": ssm_plain_ms, "bound_ms": ssm_bound,
        "bound_by": ssm_bound_by, "library_ms": None}
    qmm = {"launches": k2_launches, "max_abs_err": qmm_err,
           "falcon_mamba_step_ms": k2["ms"],
           "falcon_mamba_step_plain_ms": k2["plain_ms"],
           "falcon_mamba_step_library_ms": k2["library_ms"],
           "falcon_mamba_step_eager_ms": k2["eager_ms"],
           "falcon_mamba_step_eager_plain_ms": k2["eager_plain_ms"],
           "falcon_mamba_step_eager_library_ms": k2["eager_library_ms"],
           "falcon_mamba_step_bound_ms": k2["bound"]}
    return ssm_entry, qmm


def _within(got, ref, tol):
    """(max abs error, largest share of the bound used, all within)."""
    import torch
    diff = (got.float() - ref.float()).abs()
    share = float((diff / torch.clamp_min(tol, 1e-30)).max())
    return float(diff.max()), share, bool((diff <= tol).all())


def _qleaves(tree):
    """The quantized leaves of a parameter tree."""
    from repro_torch.nn.layers import is_qleaf
    if is_qleaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qleaves(v)]
    if isinstance(tree, (tuple, list)):
        return [q for v in tree for q in _qleaves(v)]
    return []


def payload_on_card(params, bits: int, dev):
    """Quantize ``params`` at ``bits`` on the card and count the result:
    (tree, payload bytes, scale bytes, leaves, rows of odd width N) by
    ``nbytes``, and the bytes `torch.cuda.memory_allocated` grew by (the
    payloads and scales; the leaves left unquantized are shared)."""
    import torch
    from repro_torch.serve import quantized as QS
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    qt = QS.quantize_params(params, bits=bits)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated(dev) - base
    leaves = _qleaves(qt)
    pay = sum(q["q"].nbytes for q in leaves)
    scales = sum(q["scale"].nbytes for q in leaves)
    odd_rows = sum(q["q"].numel() // q["q"].shape[-1] for q in leaves
                   if q["scale"].shape[0] % 2)
    return qt, {"payload_bytes": pay, "scale_bytes": scales,
                "leaves": len(leaves), "odd_width_rows": odd_rows,
                "allocated_bytes": grew}


# phases 40 and 41: (arch, batch, prompt steps, greedy steps)
W4_DECODE = {"qwen3-0.6b": (8, 32, 32), "falcon-mamba-7b": (8, 16, 16)}


def w4_serving(card: str, dev):
    """Phases 39-41: K2's packed-int4 bodies alone at qwen3-0.6b's and
    falcon-mamba-7b's decode shapes and a ragged one, against the plain
    version and timed beside the int8 body and cuBLAS; then the w4 decode
    of both models at full width, their payloads on the card against
    w8's. Returns K2's launches by path and the numbers of the
    ``{"kernels": [...]}`` line's int4 entry."""
    import math

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels.quant_matmul.ops import cost as qmm_cost
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS

    gen = torch.Generator(device=dev).manual_seed(39)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    fm = ARCHS["falcon-mamba-7b"]
    d, di = fm.d_model, fm.ssm.expand * fm.d_model
    r, N_ = fm.ssm.dt_rank, fm.ssm.d_state
    # (K, N, x's type, times summed: one qwen3-0.6b layer, one
    # falcon-mamba-7b decode step)
    qwen = {n: (K, N, "bf16", 1) for n, (K, N) in QWEN3_QMM.items()}
    falcon = {"in_proj": (d, 2 * di, "bf16", fm.num_layers),
              "x_proj": (di, r + 2 * N_, "bf16", fm.num_layers),
              "dt_proj": (r, di, "f32", fm.num_layers),
              "out_proj": (di, d, "bf16", fm.num_layers),
              "lm_head": (d, fm.vocab_size, "bf16", 1)}
    out = {"k2": {}, "max_abs_err": 0.0, "largest_share_of_bound": 0.0}

    def operands(M, K, N, dname):
        x = torch.randn((M, K), generator=gen, device=dev).to(dtypes[dname])
        q = torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = (torch.rand((N,), generator=gen, device=dev) + 0.1) * 0.01
        return x, q, QM.pack_int4(q), sc

    # -- 39. the int4 bodies alone ----------------------------------------
    with Phase(39, "quant_matmul int4 body vs plain, and its times"):
        cases = {}
        for M in (1, 8, 16):
            for name, (K, N, xname, _) in {**qwen, **falcon}.items():
                for dname in sorted({xname, "f32"}):
                    cases[(M, K, N, dname)] = name
            # N odd (its last high nibble padding), ceil(N/2) = 501 no
            # multiple of 16 (single-byte staging), K no multiple of 16
            for dname in dtypes:
                cases[(M, 1000, 1001, dname)] = "ragged"
        for (M, K, N, dname), name in cases.items():
            x, _, w4, sc = operands(M, K, N, dname)
            reset_launches()
            got = QM.quant_matmul(x, w4, sc)
            torch.cuda.synchronize()
            check(LAUNCHES["quant_matmul"] == LAUNCHES["quant_matmul_int4"]
                  == 1 and LAUNCHES["quant_matmul_mma"]
                  == int(dname == "bf16")
                  and LAUNCHES["quant_matmul_wgmma"] == 0,
                  f"quant_matmul int4 {name} {(M, K, N)} {dname} took the "
                  f"wrong body: {dict(LAUNCHES)}")
            ref = QM.quant_matmul_ref(x, w4, sc)
            err, share, ok = _within(got, ref, QM.quant_matmul_tolerance(
                x, w4, sc, ref))
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["largest_share_of_bound"] = max(
                out["largest_share_of_bound"], share)
            print(f"[39] quant_matmul int4 {name} M={M} K={K} N={N} {dname} "
                  f"({'mma' if dname == 'bf16' else 'cuda-core'} body): max "
                  f"abs err {err:.3e}, largest share of the bound "
                  f"{share:.3f}, within={ok}")
            check(ok, f"quant_matmul's int4 body disagrees at {name} "
                  f"{(M, K, N)} {dname}")
            del x, w4, sc, got, ref

        # device times at M = 8 (CUDA graphs over weight sets rotated past
        # the L2), the int4 body eager beside; the int8 body on the same
        # values, torch.matmul on the dequantized weight in x's type
        M = 8
        for label, shapes in (("qwen3_layer", qwen),
                              ("falcon_mamba_step", falcon)):
            tot = dict.fromkeys(("ms", "eager_ms", "plain_ms", "int8_ms",
                                 "library_ms", "bound_ms", "bytes"), 0.0)
            bound_by = set()
            for name, (K, N, xname, weight) in shapes.items():
                xdt = dtypes[xname]
                copies = max(2, math.ceil(120e6 / (K * ((N + 1) // 2))))
                x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
                sets4, sets8, deq = [], [], []
                for _ in range(copies):
                    _, q, w4, sc = operands(M, K, N, xname)
                    sets4.append((x, w4, sc))
                    sets8.append((x, q, sc))
                    deq.append((x, L.dequantize({"q": w4, "scale": sc},
                                                xdt)))
                    del q
                t = dict(
                    ms=_graph_ms(QM.quant_matmul, sets4, reps=4 * copies),
                    eager_ms=_rotating_ms(QM.quant_matmul, sets4,
                                          reps=4 * copies),
                    plain_ms=_graph_ms(QM.quant_matmul_ref, sets4,
                                       reps=max(2, copies)),
                    int8_ms=_graph_ms(QM.quant_matmul, sets8,
                                      reps=4 * copies),
                    library_ms=_graph_ms(torch.matmul, deq,
                                         reps=4 * copies))
                t["bound_ms"], by = qmm_bound_ms(M, K, N, x.element_size(),
                                                 packed=True)
                bound_by.add(by)
                int8_bound, _ = qmm_bound_ms(M, K, N, x.element_size())
                t["bytes"] = qmm_cost(M, K, N, x.element_size(), True)[1]
                print(f"[39] {card}: quant_matmul {name} M={M} K={K} N={N} "
                      f"{xname}: int4 body {t['ms']:.4f} ms on the device "
                      f"(eager {t['eager_ms']:.4f}), int8 body "
                      f"{t['int8_ms']:.4f}, plain {t['plain_ms']:.4f}, "
                      f"torch.matmul on the dequantized {xname} weight "
                      f"{t['library_ms']:.4f}; bound {t['bound_ms']:.5f} ms "
                      f"({by}; int8 {int8_bound:.5f}); int4 "
                      f"{t['ms'] / t['bound_ms']:.1f}x its bound, "
                      f"{t['ms'] / t['int8_ms']:.3f}x the int8 body")
                for key, val in t.items():
                    tot[key] += weight * val
                del sets4, sets8, deq, x
            tot["bound_by"] = "/".join(sorted(bound_by))
            print(f"[39] {card}: quant_matmul int4, {label} on the device: "
                  f"int4 body {tot['ms']:.4f} ms, int8 body "
                  f"{tot['int8_ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
                  f"ms, torch.matmul {tot['library_ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.5f} ms; eager int4 "
                  f"{tot['eager_ms']:.4f} ms")
            out[label] = tot

    # -- 40, 41. w4 decode at full width ------------------------------------
    for n, arch in ((40, "qwen3-0.6b"), (41, "falcon-mamba-7b")):
        cfg = ARCHS[arch]
        Bd, P, G = W4_DECODE[arch]
        ssm = cfg.ssm is not None
        layers = cfg.num_layers
        per_step = 4 * layers + 1 if ssm else 7 * layers
        mma_step = per_step - layers if ssm else per_step   # dt_proj float32
        rel_bound = layers * 2.0 ** -8      # as phases 9 and 15
        with Phase(n, f"{arch} w4 decode"):
            t0 = time.perf_counter()
            params = T.init(gen, cfg, device=dev)
            torch.cuda.synchronize()
            print(f"[{n}] {arch}: {T.param_count(params)} parameters drawn "
                  f"in {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            q8, pay8 = payload_on_card(params, 8, dev)
            del q8
            gc.collect()
            torch.cuda.empty_cache()
            qparams, pay4 = payload_on_card(params, 4, dev)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[{n}] {arch}: quantized at 8 and at 4 bits in "
                  f"{time.perf_counter() - t0:.3f} s")
            # the allocator rounds each tensor to 512 bytes; 1 MiB for what
            # else the card allocates meanwhile (256 KiB seen after phase 17)
            slack = 512 * 2 * pay4["leaves"] + 2 ** 20
            print(f"[{n}] {card}: {arch} payloads on the card: w8 "
                  f"{pay8['payload_bytes'] / 2**30:.4f} GiB + scales "
                  f"{pay8['scale_bytes'] / 2**20:.3f} MiB "
                  f"(memory_allocated grew {pay8['allocated_bytes'] / 2**30:.4f}"
                  f" GiB); w4 {pay4['payload_bytes'] / 2**30:.4f} GiB + "
                  f"scales {pay4['scale_bytes'] / 2**20:.3f} MiB (grew "
                  f"{pay4['allocated_bytes'] / 2**30:.4f} GiB); "
                  f"{pay4['leaves']} leaves, {pay4['odd_width_rows']} rows of "
                  f"odd width; w4/w8 payload "
                  f"{pay4['payload_bytes'] / pay8['payload_bytes']:.6f}")
            check(pay4["leaves"] == pay8["leaves"]
                  and pay4["scale_bytes"] == pay8["scale_bytes"]
                  and 2 * pay4["payload_bytes"] == pay8["payload_bytes"]
                  + pay4["odd_width_rows"],
                  f"{arch}: the w4 payload is not half of w8's: {pay4} "
                  f"{pay8}")
            for pay in (pay4, pay8):
                check(abs(pay["allocated_bytes"] - pay["payload_bytes"]
                          - pay["scale_bytes"]) <= slack,
                      f"{arch}: memory_allocated grew by "
                      f"{pay['allocated_bytes']} bytes, the tree's payload "
                      f"and scales are {pay['payload_bytes']} + "
                      f"{pay['scale_bytes']}")
            check(all(L.is_packed(q["q"]) for q in _qleaves(qparams)),
                  f"{arch}: a w4 payload is not packed")
            serve = QS.make_quant_serve_step(cfg)
            prompt = torch.randint(0, cfg.vocab_size, (Bd, P),
                                   generator=gen, device=dev)
            state = T.init_decode_state(cfg, Bd, P + G, cfg.dtype,
                                        device=dev)
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
            k2 = launches["quant_matmul"]
            print(f"[{n}] w4 decode, batch {Bd}, {P} prompt + {G} greedy "
                  f"steps: launches {launches} ({k2 / (P + G):.0f} "
                  f"quant_matmul a step)")
            check(k2 == per_step * (P + G),
                  f"quant_matmul launched {k2} times in {P + G} steps, not "
                  f"{per_step} a step")
            check(launches["quant_matmul_int4"] == k2,
                  f"{launches['quant_matmul_int4']} of {k2} quant_matmul "
                  f"launches took the int4 body")
            check(launches["quant_matmul_mma"] == mma_step * (P + G)
                  and launches["quant_matmul_wgmma"] == 0,
                  f"{launches['quant_matmul_mma']} quant_matmul launches "
                  f"took the mma path, not {mma_step * (P + G)} "
                  f"({launches['quant_matmul_wgmma']} the large-M body)")
            step_ms = (t1 - t0) / (P + G) * 1e3
            print(f"[{n}] {card}: w4 decode {step_ms:.3f} ms a step; greedy "
                  f"part {Bd * G / (t1 - t_gen):.1f} tokens/s")

            def teacher_forced():
                st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype,
                                         device=dev)
                lgs = []
                for inp in fed:
                    lg, st = T.decode_step(qparams, st, inp, cfg)
                    lgs.append(lg[:, 0])
                return torch.stack(lgs)

            t0 = time.perf_counter()
            kern = teacher_forced()
            L.quant_matmul = QM.quant_matmul_ref
            try:
                plain = teacher_forced()
            finally:
                L.quant_matmul = QM.quant_matmul
            rels = [_rel(kern[i], plain[i]) for i in range(P + G)]
            agree = float((kern.argmax(-1) == plain.argmax(-1)).float()
                          .mean())
            fed_greedy = torch.cat(fed[P:], 1)
            gen_greedy = kern[P - 1:-1].argmax(-1).t()
            print(f"[{n}] teacher-forced runs, kernel and plain: "
                  f"{time.perf_counter() - t0:.3f} s")
            print(f"[{n}] teacher-forced logits, kernel vs K2's plain "
                  f"version, per step relative L2 (bound {rel_bound:.3e}): "
                  + " ".join(f"{v:.2e}" for v in rels))
            print(f"[{n}] argmax agreement {agree:.4f} over "
                  f"{Bd * (P + G)} positions; the serve step's greedy tokens "
                  f"reproduced: {bool((fed_greedy == gen_greedy).all())}")
            check(bool(torch.isfinite(kern).all()), "decode logits not "
                  "finite")
            check(bool((fed_greedy == gen_greedy).all()),
                  "teacher-forced kernel run does not reproduce the greedy "
                  "tokens of the serve step")
            check(max(rels) <= rel_bound, "w4 decode logits differ from the "
                  "plain version's beyond the bound")
            del kern, plain

            def eight_steps():
                st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype,
                                         device=dev)
                for inp in fed[:8]:
                    serve(qparams, st, inp)

            # the device's activity alone: recording every host op of
            # 25-45k kernels takes most of a minute
            wall_s, busy_s, n_k = device_busy(eight_steps, cpu=False)
            print(f"[{n}] {card}: 8 w4 decode steps: wall {wall_s:.4f} s, "
                  f"device busy {busy_s:.4f} s in {n_k} kernels, busy share "
                  f"{busy_s / wall_s:.3f}")
            out["k2"][f"{arch} w4 decode, {P + G} steps (phase {n})"] = k2
            out[arch] = {"w8_payload": pay8, "w4_payload": pay4,
                         "step_ms": step_ms, "busy_share": busy_s / wall_s,
                         "max_rel_l2": max(rels)}
            del qparams, state, fed, prompt, nxt
            gc.collect()
            torch.cuda.empty_cache()
    return out


# phase 42: K2's two bodies swept over M at qwen3-0.6b's gate/up (K, N)
# and the vision cross projection's, and the large-M body at the w8
# steps' cross K/V shapes (M = 8 x the context's length)
WIDE_SWEEP_M = (16, 32, 64, 128, 256, 512, 1024)
WIDE_SWEEP_KN = {"qwen3-0.6b gate/up": (1024, 3072),
                 "vision cross K/V": (4096, 1024)}
WIDE_SHAPES = {"llama-3.2-vision cross K/V": (12808, 4096, 1024),
               "whisper-base cross K/V": (12000, 512, 512)}
# where the large-M body's rounds of blocks hardly matter (31-32 and 62-63
# rounds at either row count): its time a row with blocks of 160 rows of
# x against 128, the ratio `ops.ROW_COST` states
WIDE_ROWS_SHAPES = ((16384, 4096, 4096), (16384, 2048, 8192))


def wide_products(card: str, dev):
    """Phase 42: K2's large-M body (``wgmma``) beside its decode body.
    The sweep times both through their C entry points (device time from
    CUDA graphs over weight sets past the L2) and finds, for each payload
    kind, the smallest M of the sweep from which the large-M body is no
    slower at both shapes; then at the cross K/V shapes, int8 and packed
    int4, the wrapper's call is held against the plain version within
    `quant_matmul_tolerance`, counted once in
    ``LAUNCHES["quant_matmul_wgmma"]``, equal to the bit on a rerun, and
    timed beside the decode body, cuBLAS on the dequantized weight, the
    plain version and the bound; an unaligned view of x takes the decode
    body. Returns the numbers for K2's entry."""
    import math

    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels.quant_matmul import ops as QMO
    from repro_torch.kernels.quant_matmul.ref import weights

    gen = torch.Generator(device=dev).manual_seed(42)
    kinds = {"int8": False, "int4": True}

    def operands(M, K, N, packed, copies):
        sets = []
        for _ in range(copies):
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            q = torch.randint(-8 if packed else -127, 8 if packed else 128,
                              (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            s = (torch.rand((N,), generator=gen, device=dev) + 0.1) * 0.01
            sets.append((x, QM.pack_int4(q) if packed else q, s))
        return sets

    def entry_point(name, x, w, s, *flags):
        M, K = x.shape
        N = s.shape[0]
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        rc = QMO._kernel(name)(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                               y.data_ptr(), M, K, N, *flags,
                               torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"quant_matmul_{name} {(M, K, N)}: CUDA error {rc}")
        return y

    def decode_body(x, w, s):
        """the decode body's C function (the wrapper takes the large-M
        body at these shapes)"""
        return entry_point(("int4_" if w.dtype == torch.uint8 else "")
                           + "bf16", x, w, s, QMO._flags(x, w))

    def wide_body(x, w, s, rows=None):
        return entry_point("wide_" + ("int4_" if w.dtype == torch.uint8
                                      else "") + "bf16", x, w, s,
                           rows or QMO.wgmma_rows(x.shape[0], s.shape[0]))

    out = {"sweep": {}, "threshold": {}, "rows": {}, "shapes": {},
           "launches": 0,
           "max_abs_err": 0.0, "largest_share_of_bound": 0.0}
    with Phase(42, "quant_matmul's large-M body"):
        for kind, packed in kinds.items():
            faster = {M: True for M in WIDE_SWEEP_M}
            for label, (K, N) in WIDE_SWEEP_KN.items():
                copies = max(2, math.ceil(120e6 / (K * N)))
                for M in WIDE_SWEEP_M:
                    sets = operands(M, K, N, packed, copies)
                    reps = 2 * copies
                    dec = _graph_ms(decode_body, sets, reps)
                    wid = _graph_ms(wide_body, sets, reps)
                    faster[M] = faster[M] and wid <= dec
                    out["sweep"][f"{kind} {label} M={M}"] = {
                        "decode_ms": dec, "wgmma_ms": wid}
                    print(f"[42] {card}: sweep {kind} {label} M={M} K={K} "
                          f"N={N}: decode body {dec:.4f} ms, large-M body "
                          f"{wid:.4f} ms on the device")
                    del sets
            # the smallest M from which the large-M body is no slower at
            # both shapes, at that M and every larger one of the sweep
            first = None
            for M in reversed(WIDE_SWEEP_M):
                if not faster[M]:
                    break
                first = M
            out["threshold"][kind] = first
            print(f"[42] {card}: {kind}: the large-M body is no slower at "
                  f"both shapes from M = {first} of the sweep on; the "
                  f"wrapper takes it from M = "
                  f"{QMO.wgmma_min_m(packed)}")
        for M, K, N in WIDE_ROWS_SHAPES:
            sets = operands(M, K, N, False, 2)
            per_row = {}
            for rows in QMO.WGMMA_ROWS:
                ms = _graph_ms(lambda a, b, c: wide_body(a, b, c, rows),
                               sets, 6)
                rounds = math.ceil(math.ceil(N / QMO.WGMMA_COLS)
                                   * math.ceil(M / rows) / 132)
                per_row[rows] = ms / rounds / rows
                out["rows"][f"M={M} K={K} N={N} rows={rows}"] = ms
            ratio = per_row[160] / per_row[128]
            out["rows"][f"M={M} K={K} N={N} ratio"] = ratio
            print(f"[42] {card}: M={M} K={K} N={N} int8: a block's time a "
                  f"row of x with 160 rows {ratio:.3f} of that with 128 "
                  f"(ms {out['rows'][f'M={M} K={K} N={N} rows=160']:.4f} "
                  f"and {out['rows'][f'M={M} K={K} N={N} rows=128']:.4f}); "
                  f"ROW_COST states {QMO.ROW_COST[160]}")
            del sets
        for label, (M, K, N) in WIDE_SHAPES.items():
            for kind, packed in kinds.items():
                copies = max(2, math.ceil(100e6 / (M * K * 2)))
                sets = operands(M, K, N, packed, copies)
                x, w, s = sets[0]
                reset_launches()
                got = QM.quant_matmul(x, w, s)
                torch.cuda.synchronize()
                check(LAUNCHES["quant_matmul"] == LAUNCHES[
                    "quant_matmul_wgmma"] == 1 and LAUNCHES[
                    "quant_matmul_int4"] == int(packed),
                      f"{label} {kind}: the large-M body was not taken: "
                      f"{dict(LAUNCHES)}")
                again = QM.quant_matmul(x, w, s)
                torch.cuda.synchronize()
                out["launches"] += 2
                ref = QM.quant_matmul_ref(x, w, s)
                err, share, ok = _within(got, ref, QM.quant_matmul_tolerance(
                    x, w, s, ref))
                check(ok and torch.equal(got, again),
                      f"{label} {kind}: the large-M body differs from the "
                      f"plain version beyond the bound ({share:.3f} of it) "
                      f"or from itself on a rerun")
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["largest_share_of_bound"] = max(
                    out["largest_share_of_bound"], share)
                # an x view off a 16-byte boundary: TMA cannot read it
                flat = torch.empty(M * K + 8, dtype=x.dtype, device=dev)
                xu = flat[1:1 + M * K].view(M, K)
                xu.copy_(x)
                reset_launches()
                got_u = QM.quant_matmul(xu, w, s)
                torch.cuda.synchronize()
                check(LAUNCHES["quant_matmul_mma"] == 1
                      and LAUNCHES["quant_matmul_wgmma"] == 0,
                      f"{label} {kind}: an unaligned x did not take the "
                      f"decode body: {dict(LAUNCHES)}")
                check(_within(got_u, ref, QM.quant_matmul_tolerance(
                    x, w, s, ref))[2], f"{label} {kind}: the decode body "
                      f"on an unaligned x differs from the plain version")
                del flat, xu, got_u, again
                reps = 2 * copies
                lib_sets = [(a, (weights(b, c).float() * c).to(
                    torch.bfloat16)) for a, b, c in sets]
                bound, by = qmm_bound_ms(M, K, N, 2, packed)
                rows = QMO.wgmma_rows(M, N)
                other = [r for r in QMO.WGMMA_ROWS if r != rows][0]
                res = {"M": M, "K": K, "N": N, "payload": kind,
                       "rows": rows,
                       "ms": _graph_ms(QM.quant_matmul, sets, reps),
                       f"rows_{other}_ms": _graph_ms(
                           lambda a, b, c: wide_body(a, b, c, other), sets,
                           reps),
                       "decode_body_ms": _graph_ms(decode_body, sets,
                                                   max(2, reps // 2)),
                       "library_ms": _graph_ms(torch.matmul, lib_sets, reps),
                       "plain_ms": _graph_ms(QM.quant_matmul_ref, sets[:1],
                                             2),
                       "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err, "share_of_bound_err": share}
                del lib_sets, sets, got, ref
                out["shapes"][f"{label} {kind}"] = res
                print(f"[42] {card}: {label} {kind} M={M} K={K} N={N}: "
                      f"large-M body {res['ms']:.4f} ms on the device "
                      f"({rows} rows a block; {other} rows "
                      f"{res[f'rows_{other}_ms']:.4f}), decode body "
                      f"{res['decode_body_ms']:.4f}, cuBLAS on the "
                      f"dequantized weight {res['library_ms']:.4f}, "
                      f"plain {res['plain_ms']:.4f}, bound {bound:.5f} ms "
                      f"({by}): {res['ms'] / bound:.2f}x the bound, "
                      f"{res['ms'] / res['library_ms']:.2f}x cuBLAS; max abs "
                      f"err {err:.3e} ({share:.3f} of the tolerance), equal "
                      f"to the bit on a rerun")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cmm_bound_ms(M, K, N, C, x_bytes):
    """(bound ms, "bytes" or "operations") of y = x @ W with W gathered
    from per-row codebooks: x, the int8 indices and the codebooks read once,
    y written once; 2MKN operations at the tensor-core rate of x's type
    (the wrapper's `cost`)."""
    from repro_torch.kernels.clustered_matmul.ops import cost
    ops, nbytes = cost(M, K, N, C, x_bytes)
    rate = BF16_TENSOR_FLOPS if x_bytes == 2 else TF32_TENSOR_FLOPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def bsmm_bound_ms(M, K, N, live, mask_bytes, x_bytes):
    """(bound ms, "bytes" or "operations") of the block-sparse product with
    a ``live`` share of its weight tiles: x, the live weights and the mask
    read once, y written once; 2MKN x live operations (the wrapper's
    `cost`)."""
    from repro_torch.kernels.block_sparse_matmul.ops import cost
    ops, nbytes = cost(M, K, N, live, mask_bytes, x_bytes)
    rate = BF16_TENSOR_FLOPS if x_bytes == 2 else TF32_TENSOR_FLOPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def qwen3_matrices(params, cfg):
    """qwen3-0.6b's 196 layer matrices as the 2-D (K, N) its products use,
    layer by layer in the order of ``QWEN3_QMM``: views, no copies."""
    check(len(cfg.segments) == 1 and len(cfg.segments[0].pattern) == 1,
          "qwen3-0.6b is one segment of one repeated block")
    blk = params["segments"][0][0]
    att, mlp = blk["mixer"], blk["mlp"]
    leaves = {"wq": att["wq"], "wk": att["wk"], "wv": att["wv"],
              "wo": att["wo"], "wi_gate": mlp["wi_gate"],
              "wi_up": mlp["wi_up"], "mlp_wo": mlp["wo"]}
    out = []
    for layer in range(cfg.num_layers):
        for name, (K, N) in QWEN3_QMM.items():
            w = leaves[name]["kernel"][layer].reshape(K, N)
            check(w.is_contiguous(), f"{name} of layer {layer} is a copy")
            out.append((name, w))
    return out


def compressed_products(card: str, dev):
    """Phases 18-21: K3 (clustered_matmul) and K4 (block_sparse_matmul)
    against their plain versions on the card, then every product of
    qwen3-0.6b at full width compressed by the port's own producers and run
    through both kernels, then their times. Returns K2's device times at
    those shapes and K3's and K4's entries of the ``{"kernels": [...]}``
    line."""
    import math

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.core import clustering as CL
    from repro_torch.core import pruning as PR
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import block_sparse_matmul as BS
    from repro_torch.kernels import clustered_matmul as CM
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels.block_sparse_matmul.ref import live_weight
    from repro_torch.kernels.quant_matmul import ops as QMO
    from repro_torch.nn import transformer as T

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    decode = [(8,) + kn for kn in QWEN3_QMM.values()]

    def cmm_inputs(M, K, N, C, dt, idx_dt):
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        idx = torch.randint(0, C, (K, N), generator=gen, device=dev).to(
            idx_dt)
        cb = torch.randn((K, C), generator=gen, device=dev) * 0.05
        return x, idx, cb

    def bsmm_inputs(M, K, N, bk, bn, live, dt):
        """A uniform mask at a live share, or "skewed": the first quarter of
        the column strips fully live, the rest at a third, half live in
        all."""
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        w = (torch.randn((K, N), generator=gen, device=dev) * 0.05).to(dt)
        u = torch.rand((K // bk, N // bn), generator=gen, device=dev)
        if live == "skewed":
            bm = u < 1 / 3
            bm[:, :max(1, N // bn // 4)] = True
        else:
            bm = u < live
        return x, w, bm

    # -- 18. K3 against its plain version ---------------------------------
    cmm_err, cmm_share = 0.0, 0.0
    with Phase(18, "clustered_matmul vs plain"):
        cases = [(s, 16, "int8") for s in decode] + [
            ((20, 70, 40), 3, "int8"), ((20, 70, 40), 3, "int32"),
            ((8, 1024, 3072), 16, "int32"), ((8, 1024, 3072), 300, "int32"),
            ((4096, 1024, 3072), 16, "int8")]
        for (M, K, N), C, iname in cases:
            for dname, dt in dtypes.items():
                x, idx, cb = cmm_inputs(M, K, N, C, dt, getattr(torch, iname))
                got = CM.clustered_matmul(x, idx, cb)
                torch.cuda.synchronize()
                ref = CM.clustered_matmul_ref(x, idx, cb)
                err, share, ok = _within(
                    got, ref, CM.clustered_matmul_tolerance(x, idx, cb, ref))
                cmm_err, cmm_share = max(cmm_err, err), max(cmm_share, share)
                print(f"[18] clustered_matmul M={M} K={K} N={N} C={C} "
                      f"{iname} {dname}: max abs err {err:.3e}, largest "
                      f"share of the bound {share:.3e}, within={ok}")
                check(ok, f"clustered_matmul disagrees at {(M, K, N, C)} "
                      f"{iname} {dname}")
                del x, idx, cb, got, ref
        # fault F2: an index outside [0, C) weighs 0, in the kernel as in
        # the plain version (and the Pallas kernel)
        for iname in ("int8", "int32"):
            x, idx, cb = cmm_inputs(8, 1024, 1024, 4, torch.bfloat16,
                                    torch.int32)
            idx[::2, 0], idx[1::2, 0], idx[::7, 5] = 4, -1, 5
            idx = idx.to(getattr(torch, iname))
            got = CM.clustered_matmul(x, idx, cb)
            torch.cuda.synchronize()
            ref = CM.clustered_matmul_ref(x, idx, cb)
            err, share, ok = _within(
                got, ref, CM.clustered_matmul_tolerance(x, idx, cb, ref))
            # column 0 has no index inside [0, C): exactly zero
            ok = ok and int(torch.count_nonzero(got[:, 0])) == 0
            print(f"[18] clustered_matmul M=8 K=1024 N=1024 C=4 {iname} "
                  f"bf16, indices C, C + 1 and -1 in columns 0 and 5: max "
                  f"abs err {err:.3e}, largest share of the bound "
                  f"{share:.3e}, column 0 zero and within={ok}")
            check(ok, f"clustered_matmul disagrees on out-of-range "
                  f"{iname} indices")
            del x, idx, cb, got, ref

    # -- 19. K4 against its plain version ---------------------------------
    bsmm_err, bsmm_share = 0.0, 0.0
    with Phase(19, "block_sparse_matmul vs plain"):
        cases = [(s, (128, 128), live, "") for s in decode
                 for live in (1.0, 0.5, 0.1)] + [
            ((8, 1024, 3072), (32, 32), 0.5, ""),
            ((8, 1024, 3072), (16, 16), 0.5, ""),
            ((8, 1024, 3072), (8, 128), 0.5, ""),
            ((8, 1024, 3072), (128, 128), "skewed", ""),
            ((8, 3072, 1024), (128, 128), "skewed", ""),
            ((1, 1024, 3072), (128, 128), 0.5, ""),
            ((16, 1024, 3072), (8, 128), "skewed", ""),
            ((20, 1024, 1024), (128, 128), 0.5, "dead"),
            ((13, 256, 160), (16, 16), 0.5, "dead"),
            ((4096, 1024, 3072), (128, 128), 0.5, "")]
        for (M, K, N), (bk, bn), live, dead in cases:
            for dname, dt in dtypes.items():
                x, w, bm = bsmm_inputs(M, K, N, bk, bn, live, dt)
                if dead:   # tile (1, 0) dead below a live one, its weights
                    bm[0, 0] = True    # non-zero; the last column strip dead
                    bm[1, 0] = False
                    bm[:, -1] = False
                reset_launches()
                got = BS.block_sparse_matmul(x, w, bm, block_k=bk,
                                             block_n=bn)
                torch.cuda.synchronize()
                check(LAUNCHES["block_sparse_matmul_mma"]
                      == int(dname == "bf16"),
                      f"block_sparse_matmul {(M, K, N)} {dname} took the "
                      f"wrong body")
                ref = BS.block_sparse_matmul_ref(x, w, bm, block_k=bk,
                                                 block_n=bn)
                err, share, ok = _within(
                    got, ref, BS.block_sparse_matmul_tolerance(
                        x, w, bm, ref, block_k=bk, block_n=bn))
                if dead:
                    ok = ok and int(torch.count_nonzero(got[:, N - bn:])) == 0
                bsmm_err = max(bsmm_err, err)
                bsmm_share = max(bsmm_share, share)
                print(f"[19] block_sparse_matmul M={M} K={K} N={N} tiles "
                      f"({bk}, {bn}) live {float(bm.float().mean()):.3f}"
                      f"{' dead tile + dead strip' if dead else ''} {dname}: "
                      f"max abs err {err:.3e}, largest share of the bound "
                      f"{share:.3e}, within={ok}")
                check(ok, f"block_sparse_matmul disagrees at {(M, K, N)} "
                      f"tiles {(bk, bn)} live {live} {dname}")
                del x, w, bm, got, ref

    # -- 20. qwen3-0.6b's products, compressed, at full width -------------
    cfg = ARCHS["qwen3-0.6b"]
    K_CLUSTERS, SPARSITY, TILE = 16, 0.5, 128
    with Phase(20, "qwen3-0.6b compressed products"):
        params = T.init(gen, cfg, device=dev)
        n_params = T.param_count(params)
        check(n_params == 596049920, f"{n_params} parameters, not the JAX "
              "package's 596049920")
        mats = qwen3_matrices(params, cfg)
        check(len(mats) == 7 * cfg.num_layers, f"{len(mats)} matrices")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clustered = []
        for _, w in mats:
            cb, idx = CL.cluster_per_input(w, K_CLUSTERS)
            clustered.append((cb, idx.to(torch.int8)))
        torch.cuda.synchronize()
        cluster_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # tile norms in float32: bf16 norms of 16384 weights drawn alike
        # tie at the threshold
        tiles = [PR.block_mask(w.float(), SPARSITY, (TILE, TILE))
                 [::TILE, ::TILE].contiguous() for _, w in mats]
        torch.cuda.synchronize()
        prune_s = time.perf_counter() - t0
        live_share = float(sum(int(t.sum()) for t in tiles)
                           / sum(t.numel() for t in tiles))
        print(f"[20] qwen3-0.6b: {n_params} parameters; {len(mats)} layer "
              f"matrices clustered per input row at k={K_CLUSTERS} "
              f"(cluster_per_input, indices stored int8) in {cluster_s:.3f} "
              f"s; block-pruned at sparsity {SPARSITY} in {TILE} x {TILE} "
              f"tiles (block_mask) in {prune_s:.3f} s, live share "
              f"{live_share:.4f}")
        xs = {K: torch.randn((8, K), generator=gen, device=dev).to(
            torch.bfloat16) for K in {k for k, _ in QWEN3_QMM.values()}}

        def k3_step():
            return [CM.clustered_matmul(xs[w.shape[0]], idx, cb)
                    for (_, w), (cb, idx) in zip(mats, clustered)]

        def k4_step():
            return [BS.block_sparse_matmul(xs[w.shape[0]], w, t,
                                           block_k=TILE, block_n=TILE)
                    for (_, w), t in zip(mats, tiles)]

        torch.cuda.synchronize()
        reset_launches()
        y3 = k3_step()
        torch.cuda.synchronize()
        k3_launches = dict(LAUNCHES)
        reset_launches()
        y4 = k4_step()
        torch.cuda.synchronize()
        k4_launches = dict(LAUNCHES)
        print(f"[20] one decode step's products at M=8 through K3: "
              f"launches {k3_launches}; through K4: launches {k4_launches}")
        check(k3_launches["clustered_matmul"] == len(mats)
              and sum(k3_launches.values()) == len(mats),
              f"K3 step launched {k3_launches}")
        check(k4_launches["block_sparse_matmul"] == len(mats)
              and k4_launches["block_sparse_matmul_mma"] == len(mats)
              and sum(k4_launches.values()) == 2 * len(mats),
              f"K4 step launched {k4_launches}, not {len(mats)} through "
              f"the tensor-core body")
        share3 = share4 = 0.0
        for (name, w), (cb, idx), t, a, b in zip(mats, clustered, tiles, y3,
                                                 y4):
            x = xs[w.shape[0]]
            check(tuple(a.shape) == (8, w.shape[1]) and tuple(b.shape) ==
                  (8, w.shape[1]) and bool(torch.isfinite(a).all())
                  and bool(torch.isfinite(b).all()),
                  f"{name}: outputs not finite or of the wrong shape")
            ref = CM.clustered_matmul_ref(x, idx, cb)
            err, share, ok = _within(
                a, ref, CM.clustered_matmul_tolerance(x, idx, cb, ref))
            check(ok, f"K3 disagrees on {name}")
            cmm_err, share3 = max(cmm_err, err), max(share3, share)
            ref = BS.block_sparse_matmul_ref(x, w, t, block_k=TILE,
                                             block_n=TILE)
            err, share, ok = _within(b, ref, BS.block_sparse_matmul_tolerance(
                x, w, t, ref, block_k=TILE, block_n=TILE))
            check(ok, f"K4 disagrees on {name}")
            bsmm_err, share4 = max(bsmm_err, err), max(share4, share)
        cmm_share = max(cmm_share, share3)
        bsmm_share = max(bsmm_share, share4)
        print(f"[20] all {2 * len(mats)} outputs within their bounds against "
              f"the plain versions: largest share of the bound used, K3 "
              f"{share3:.3e}, K4 {share4:.3e}")
        del y3, y4

    # -- 21. times ---------------------------------------------------------
    # At M = 8 a product can take less device time than its eager call takes
    # on the host (cuBLAS's do), so the times here are the device's: the
    # calls are captured in a CUDA graph and replayed between CUDA events
    # (`_graph_ms`). The eager loop's time is printed beside the kernel's.
    with Phase(21, "clustered_matmul and block_sparse_matmul times"):
        # one decode step: 196 products, 440 MB of int8 indices or 880 MB
        # of bf16 weights, far past the L2
        rec = [CL.reconstruct_per_input(cb, idx).to(torch.bfloat16)
               for cb, idx in clustered]
        pre = [live_weight(w, t, block_k=TILE, block_n=TILE)
               for (_, w), t in zip(mats, tiles)]
        steps = {
            "k3": k3_step,
            "k3_plain": lambda: [
                CM.clustered_matmul_ref(xs[w.shape[0]], idx, cb)
                for (_, w), (cb, idx) in zip(mats, clustered)],
            "k3_library": lambda: [torch.matmul(xs[r.shape[0]], r)
                                   for r in rec],
            "k4": k4_step,
            "k4_plain": lambda: [
                BS.block_sparse_matmul_ref(xs[w.shape[0]], w, t,
                                           block_k=TILE, block_n=TILE)
                for (_, w), t in zip(mats, tiles)],
            "k4_library": lambda: [torch.matmul(xs[p.shape[0]], p)
                                   for p in pre],
        }
        step = {key: _graph_ms(fn, [()], reps=3) for key, fn in steps.items()}
        eager = {key: event_ms(steps[key], reps=10, warmup=2)
                 for key in ("k3", "k4")}
        k3_bound = k4_bound = 0.0
        k3_by, k4_by = set(), set()
        for (_, w), (cb, _), t in zip(mats, clustered, tiles):
            K, N = w.shape
            b, by = cmm_bound_ms(8, K, N, cb.shape[1], 2)
            k3_bound += b
            k3_by.add(by)
            b, by = bsmm_bound_ms(8, K, N, float(t.float().mean()),
                                  t.numel(), 2)
            k4_bound += b
            k4_by.add(by)
        for key, name, bound, by, lib in (
                ("k3", "clustered_matmul", k3_bound, k3_by, "reconstructed"),
                ("k4", f"block_sparse_matmul at live share {live_share:.4f}",
                 k4_bound, k4_by, "pre-masked")):
            print(f"[21] {card}: qwen3-0.6b decode step, {len(mats)} "
                  f"products at M=8, bf16 x, {name}: kernel "
                  f"{step[key]:.4f} ms on the device (an eager loop of the "
                  f"same launches {eager[key]:.4f} ms), plain "
                  f"{step[key + '_plain']:.4f} ms, torch.matmul on the {lib} "
                  f"bf16 weights {step[key + '_library']:.4f} ms, bound "
                  f"{bound:.5f} ms ({'/'.join(sorted(by))}); "
                  f"{step[key] / bound:.1f}x the bound")
        del rec, pre, clustered, tiles, mats, params, steps
        gc.collect()
        torch.cuda.empty_cache()

        def timed(label, kernel, plain, library, sets, lib_sets, bound, by,
                  reps, **extra):
            out = dict(ms=_graph_ms(kernel, sets, reps),
                       eager_ms=_rotating_ms(kernel, sets, reps=reps),
                       plain_ms=_graph_ms(plain, sets, max(2, reps // 4)),
                       library_ms=_graph_ms(library, lib_sets, reps),
                       bound_ms=bound, bound_by=by, **extra)
            print(f"[21] {card}: {label}: kernel {out['ms']:.4f} ms on the "
                  f"device (eager {out['eager_ms']:.4f} ms), plain "
                  f"{out['plain_ms']:.4f} ms, torch.matmul "
                  f"{out['library_ms']:.4f} ms, bound {bound:.5f} ms ({by}); "
                  f"{out['ms'] / bound:.1f}x the bound")
            return out

        def k2_times(x, N, copies, reps):
            """K2 at the same shape: int8 weights, the same bytes as K3's
            indices."""
            M, K = x.shape
            sets = [(x, torch.randint(-127, 128, (K, N), generator=gen,
                                      device=dev, dtype=torch.int8),
                     torch.rand((N,), generator=gen, device=dev) * 0.01)
                    for _ in range(copies)]
            body = QMO.body_for(M, K, N, torch.bfloat16, False, True)
            return timed(f"quant_matmul M={M} K={K} N={N} bf16 ({body} "
                         f"body)",
                         QM.quant_matmul, QM.quant_matmul_ref, torch.matmul,
                         sets, [(a, (w.float() * sc).to(torch.bfloat16))
                                for a, w, sc in sets],
                         *qmm_bound_ms(M, K, N, 2), reps)

        def per_product(M, K, N, live_shares):
            """K2's, K3's and K4's times at one shape, bf16 x; at decode
            the weights rotate through more than the L2 (a large M is bound
            by operations, and two sets do). The library call is
            torch.matmul on the dequantized, reconstructed or pre-masked
            bf16 weight."""
            copies = max(2, math.ceil(120e6 / (K * N))) if M <= 64 else 2
            reps = 4 * copies if M <= 64 else 5
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            out = {"quant_matmul": k2_times(x, N, copies, reps)}
            sets = [(x,) + cmm_inputs(1, K, N, 16, torch.bfloat16,
                                      torch.int8)[1:] for _ in range(copies)]
            out["clustered_matmul"] = timed(
                f"clustered_matmul M={M} K={K} N={N} C=16 int8 bf16",
                CM.clustered_matmul, CM.clustered_matmul_ref, torch.matmul,
                sets, [(a, CL.reconstruct_per_input(cb, idx).to(
                    torch.bfloat16)) for a, idx, cb in sets],
                *cmm_bound_ms(M, K, N, 16, 2), reps)
            out["block_sparse_matmul"] = {}
            for live in live_shares:
                sets = [(x,) + bsmm_inputs(1, K, N, TILE, TILE, live,
                                           torch.bfloat16)[1:]
                        for _ in range(copies)]
                share = float(sum(float(bm.float().mean()) for _, _, bm in
                                  sets) / copies)

                def kernel(a, w, bm):
                    return BS.block_sparse_matmul(a, w, bm, block_k=TILE,
                                                  block_n=TILE)

                def plain(a, w, bm):
                    return BS.block_sparse_matmul_ref(a, w, bm, block_k=TILE,
                                                      block_n=TILE)

                out["block_sparse_matmul"][f"live_{live}"] = timed(
                    f"block_sparse_matmul M={M} K={K} N={N} tiles ({TILE}, "
                    f"{TILE}) live {share:.3f} bf16", kernel, plain,
                    torch.matmul, sets,
                    [(a, live_weight(w, bm, block_k=TILE, block_n=TILE))
                     for a, w, bm in sets],
                    *bsmm_bound_ms(M, K, N, share, sets[0][2].numel(), 2),
                    reps, live=share)
            return out

        times = {name: per_product(*args)
                 for name, args in PER_PRODUCT_SHAPES.items()}
        # K2's qwen3-0.6b decode layer (phase 11's 7 products) on the device
        k2_layer = {}
        for K, N in QWEN3_QMM.values():
            copies = max(2, math.ceil(120e6 / (K * N)))
            x = torch.randn((8, K), generator=gen, device=dev).to(
                torch.bfloat16)
            for key, val in k2_times(x, N, copies, 4 * copies).items():
                if key != "bound_by":
                    k2_layer[key] = k2_layer.get(key, 0.0) + val
        print(f"[21] {card}: quant_matmul, one qwen3-0.6b decode layer (7 "
              f"products, M=8, bf16) on the device: kernel "
              f"{k2_layer['ms']:.4f} ms (eager {k2_layer['eager_ms']:.4f} "
              f"ms), plain {k2_layer['plain_ms']:.4f} ms, torch.matmul on the "
              f"dequantized weights {k2_layer['library_ms']:.4f} ms, bound "
              f"{k2_layer['bound_ms']:.5f} ms")
        dec = times["qwen3_gate_decode"]["block_sparse_matmul"]
        t10, t100 = dec["live_0.1"]["ms"], dec["live_1.0"]["ms"]
        t50, tskew = dec["live_0.5"]["ms"], dec["live_skewed"]["ms"]
        print(f"[21] {card}: K4 at the gate's decode shape on the device: "
              f"live 0.1 {t10:.4f} ms against live 1.0 {t100:.4f} ms "
              f"({t10 / t100:.3f} of it); skewed mask (live "
              f"{dec['live_skewed']['live']:.3f}) {tskew:.4f} ms against "
              f"uniform (live {dec['live_0.5']['live']:.3f}) {t50:.4f} ms "
              f"({tskew / t50:.3f}x)")
        check(t10 < t100, "K4 at 10% live tiles is not faster than at 100%: "
              "dead tiles are not skipped")

    def entry(name, body, launches, err, share, tol, step_key, bound, by,
              lib):
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "body": body,
            "replaces": REPLACES[name], "launches": launches,
            "launches_by_path": {
                "qwen3-0.6b compressed decode step, 196 products":
                    launches},
            "max_abs_err": err, "largest_share_of_bound": share,
            "tolerance": tol,
            "shapes": "qwen3-0.6b's 196 decode products, M=8, bf16 x; "
                      "times summed over the step",
            "ms": step[step_key], "eager_ms": eager[step_key],
            "plain_ms": step[step_key + "_plain"],
            "bound_ms": bound,
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": step[step_key + "_library"], "library": lib,
            "per_product": {shape: v[name] for shape, v in times.items()}}

    k2 = {"qwen3_layer": k2_layer,
          "per_product": {shape: v["quant_matmul"]
                          for shape, v in times.items()}}
    return k2, [
        entry("clustered_matmul", "CUDA cores: split-K over a thread-block "
              "cluster, indices and codebooks staged by cp.async; an index "
              "outside [0, C) weighs 0",
              k3_launches["clustered_matmul"], cmm_err,
              cmm_share, "clustered_matmul_tolerance (2 K eps32 sum|x w| "
              "+ 2^-7 |y| for bf16)", "k3", k3_bound, k3_by,
              "torch.matmul on the reconstructed bf16 weight"),
        entry("block_sparse_matmul", "bf16: mma.sync.m16n8k16 (tensor "
              "cores), float32: CUDA cores; a cluster of blocks per 16-column "
              "strip sharing its live k16 steps, staged by cp.async",
              k4_launches["block_sparse_matmul"],
              bsmm_err, bsmm_share, "block_sparse_matmul_tolerance (2 K eps32 "
              "sum|x w live| + 2^-7 |y| for bf16)", "k4", k4_bound, k4_by,
              "torch.matmul on the pre-masked bf16 weight"),
    ]


def clamp_net(ir, width: int):
    """A hand-built classifier whose three logits are TRUNCs at the clamp
    (shift ``width - 1``) of ``width``-bit words: each logit is 0 or
    -2^(width-1), so the comparator sees ties on most samples (int32 lanes
    at width 32, int64 at 62)."""
    s = width - 9                           # 8-bit ADC lanes: 9 signed bits
    net = ir.Netlist(in_bits=8, w_bits=[8])
    x0, x1, x2 = (net.input(i) for i in range(3))
    a = net.neg(net.shl(x0, s))
    b = net.sub(net.shl(x1, s), net.shl(x2, s))
    c = net.sub(net.shl(x2, s), net.shl(x0, s))
    logits = [net.trunc(v, width - 1) for v in (a, b, c)]
    check(all(net.nodes[v].width == width for v in (a, b, c)),
          f"clamp net of width {width} is not {width} bits wide")
    net.layer_pre_ids = [logits]
    net.output_ids = list(logits)
    net.argmax(logits)
    net.validate()
    return net


def comparator_operands(net, logits):
    """The argmax comparator's operands computed from the Simulator's
    logits: a logit itself, or its TRUNC where the approximation passes
    narrowed the comparator."""
    import numpy as np
    from repro_torch.circuit.ir import Op
    pos = {nid: i for i, nid in enumerate(net.output_ids)}
    cols = []
    for a in net.nodes[net.argmax_id].args:
        n = net.nodes[a]
        if a in pos:
            cols.append(logits[:, pos[a]])
        else:
            check(n.op == Op.TRUNC and n.args[0] in pos,
                  f"comparator operand {a} is neither a logit nor its TRUNC")
            v = logits[:, pos[n.args[0]]]
            cols.append((v >> n.shift) << n.shift)
    return np.stack(cols, axis=1)


def approximation_path(card: str, dev):
    """Phases 22-24: K1 on approximated netlists against its plain version,
    the numpy oracle and the Simulator on the card; the hardware-aware
    search with the approximation genes through its entry point, then
    `fit_budget` on its chosen point; the Fig. 1 sweeps. Returns K1's
    launches on the two paths and its times on phase 22's population."""
    import numpy as np
    import torch
    from repro_torch import approx, circuit, paper
    from repro_torch.configs.printed_mlp import PRINTED_MLPS
    from repro_torch.core import batch_eval as BE
    from repro_torch.core import minimize as MZ
    from repro_torch.core.compression_spec import ModelMin
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import netlist_sim as NS
    from repro_torch.kernels.netlist_sim import ops as NSO

    t_start = time.perf_counter()
    cfg = PRINTED_MLPS["whitewine"]
    _, _, xte, yte = MZ.dataset_for(cfg)
    out = {}

    # -- 22. K1 on approximated netlists ---------------------------------
    with Phase(22, "netlist_sim on approximated netlists"):
        specs = [ModelMin.uniform(2, bits=8),
                 ModelMin.uniform(2, bits=4, sparsity=0.4, clusters=8),
                 ModelMin.uniform(2, bits=6, sparsity=0.3)]
        real = [circuit.compile_spec(cfg, s, epochs=20, device=dev)
                for s in specs]
        # (csd_drop, lsb, argmax_lsb) per layer: coefficient rounding down
        # to one CSD digit (6), accumulator truncation at the clamp (16 ->
        # each product's width - 1), comparator truncation that ties
        knobs = [(1, 2, 0), (6, 0, 0), (0, 16, 0), (1, 2, 8), (2, 3, 12)]

        def ax(net, k):
            return approx.approximate(net, approx.ApproxParams(
                (k[0],) * net.n_layers, (k[1],) * net.n_layers, k[2]))

        anets = [ax(n, k) for n, _ in real for k in knobs]
        axq = np.stack([MZ.quantize_inputs(c, xte) for _, c in real
                        for _ in knobs])
        exact_nets = [n for n, _ in real]
        xq = np.stack([MZ.quantize_inputs(c, xte) for _, c in real])
        wide = [ax(circuit.compile_netlist(synth_compiled(
            MZ, (11, 12, 12, 7), 8, seed=3)), (0, 0, 4)),
            ax(circuit.compile_netlist(synth_compiled(
                MZ, (11, 10, 7), 8, seed=4, clusters=4)), (1, 2, 6))]
        rng = np.random.default_rng(22)
        cases = {  # name: (netlists, x (P, B, n_in))
            "approx_whitewine": (anets, axq),
            "mixed_exact_and_approx": (exact_nets + anets[::2],
                                       np.concatenate([xq, axq[::2]])),
            "int64_lanes": (wide, rng.integers(0, 256, (2, 513, 11))),
            "clamp_int32_ragged_197": ([clamp_net(circuit.ir, 32)],
                                       rng.integers(0, 256, (1, 197, 3))),
            "clamp_int64": ([clamp_net(circuit.ir, 62)],
                            rng.integers(0, 256, (1, 300, 3))),
            "approx_ragged_batch_1": (anets[3:4], axq[3:4, :1]),
        }
        ties_total, max_shift = 0, {torch.int32: 0, torch.int64: 0}
        for name, (nets, x) in cases.items():
            pop = NS.pack_population(nets)
            lanes = NSO.lane_dtype(pop)
            reset_launches()
            got = NS.simulate_population(pop, x, engine="cuda", device=dev)
            torch.cuda.synchronize()
            took = "smem" if LAUNCHES["netlist_sim_smem"] else "global"
            check(LAUNCHES["netlist_sim"] == 1, f"{name}: not one launch")
            plain = NS.simulate_population(pop, x, engine="levels",
                                           device=dev)
            oracle = NS.simulate_population_ref(pop, x)
            exact = all(np.array_equal(got[k], o[k]) for o in (plain, oracle)
                        for k in ("amx", "argmax"))
            sim_ok = True
            for p, net in enumerate(nets):
                r = circuit.Simulator(net, device=dev).run(x[p])
                sim_ok &= np.array_equal(r["argmax"], got["argmax"][p])
                sim_ok &= np.array_equal(
                    comparator_operands(net, r["logits"]), got["amx"][p])
            amx = oracle["amx"]
            ties = int(((amx == amx.max(axis=-1, keepdims=True)).sum(axis=-1)
                        > 1).sum())
            ties_total += ties
            trunc = pop.op == int(circuit.Op.TRUNC)
            shift = int(pop.shift[trunc].max()) if trunc.any() else 0
            max_shift[lanes] = max(max_shift[lanes], shift)
            print(f"[22] netlist_sim {name}: P={pop.n_candidates} "
                  f"N={pop.n_slots} B={x.shape[-2]} lanes={lanes} "
                  f"body={took} TRUNC slots={int(trunc.sum())} max shift "
                  f"{shift} tied comparator inputs={ties} "
                  f"bit_exact={exact} simulator_agrees={sim_ok}")
            check(exact, f"netlist_sim kernel disagrees on {name}")
            check(sim_ok, f"the Simulator on the card disagrees with K1 on "
                  f"{name}")
            check(took == "smem", f"netlist_sim {name} took the {took} body")
        check(NSO.lane_dtype(NS.pack_population(wide)) == torch.int64,
              "the int64 case did not take int64 lanes")
        print(f"[22] tied comparator inputs over all cases: {ties_total}; "
              f"largest TRUNC shift: int32 lanes {max_shift[torch.int32]}, "
              f"int64 lanes {max_shift[torch.int64]}")
        check(ties_total > 0, "no tie at the comparator in any case")
        check(max_shift[torch.int32] == 31 and max_shift[torch.int64] == 61,
              "the TRUNC shifts did not reach the lane widths' clamps")
        check(any(n.op == circuit.Op.TRUNC
                  and n.shift == a.nodes[n.args[0]].width - 1
                  for a in anets for n in a.nodes),
              "no accumulator TRUNC at its clamp (width - 1)")

        # K1's device time on the approximated population, beside the
        # exact population of the same specs at the same batch
        xt = torch.as_tensor(axq, device=dev)
        exact15 = [n for n in exact_nets for _ in knobs]
        apop, epop = NS.pack_population(anets), NS.pack_population(exact15)
        staged = NSO.StagedLaunch(apop, xt)
        staged_exact = NSO.StagedLaunch(epop, xt)
        check(staged.tile is not None and staged_exact.tile is not None,
              "phase 22's timed populations do not take the shared-memory "
              "body")
        approx_ms = _graph_ms(staged.launch, [()], reps=50)
        exact_ms = _graph_ms(staged_exact.launch, [()], reps=50)
        print(f"[22] {card}: netlist_sim on the device at P={len(anets)} "
              f"B={axq.shape[1]}: approximated N={apop.n_slots} levels="
              f"{int(apop.n_levels.max())} {approx_ms:.4f} ms, exact "
              f"N={epop.n_slots} levels={int(epop.n_levels.max())} "
              f"{exact_ms:.4f} ms (the same specs, tile {staged.tile} and "
              f"{staged_exact.tile})")
        out["approx_population"] = {
            "shapes": f"P={len(anets)} N={apop.n_slots} B={axq.shape[1]} "
                      f"{NSO.lane_dtype(apop)}",
            "ms": approx_ms, "exact_same_specs_ms": exact_ms,
            "exact_shapes": f"P={len(exact15)} N={epop.n_slots}"}

    # -- 23. the approximation path through its entry point --------------
    with Phase(23, "whitewine search with approximation genes"):
        # each approximated candidate's scoring is counted and timed (its
        # passes, structural price and one K1 launch), as are the batched
        # finetune and the compile-and-price step around it
        scorer = approx.evaluate_netlist
        finetune, compile_price = BE._population_finetune, \
            BE._compile_and_price
        deltas, scoring_s, finetune_s, compile_price_s = [], [], [], []

        def counted(*a, **kw):
            before = LAUNCHES["netlist_sim"]
            t = time.perf_counter()
            r = scorer(*a, **kw)
            scoring_s.append(time.perf_counter() - t)
            deltas.append(LAUNCHES["netlist_sim"] - before)
            return r

        def timed_finetune(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = finetune(*a, **kw)
            torch.cuda.synchronize()
            finetune_s.append(time.perf_counter() - t)
            return out

        def timed_compile_price(*a, **kw):
            t = time.perf_counter()
            out = compile_price(*a, **kw)
            compile_price_s.append(time.perf_counter() - t)
            return out

        approx.evaluate_netlist = counted
        BE._population_finetune = timed_finetune
        BE._compile_and_price = timed_compile_price
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = paper.run("whitewine", population=8, generations=3,
                            epochs=60, approx=True, device=dev)
            torch.cuda.synchronize()
        finally:
            approx.evaluate_netlist = scorer
            BE._population_finetune = finetune
            BE._compile_and_price = compile_price
        search_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        n_approx = len(deltas)
        n_exact = launches["netlist_sim"] - sum(deltas)
        n_unique = sum(ModelMin.from_json(k).has_approx
                       for k in res["evaluations"])
        print(f"[23] search with approximation genes on {res['device']}: "
              f"{search_s:.3f} s, {res['n_evaluations']} evaluations "
              f"({n_unique} approximated); netlist_sim launches "
              f"{launches['netlist_sim']}: {n_exact} packed exact (the "
              f"baseline's, and one for each batch that held an exact "
              f"candidate), {n_approx} approximated at P = 1 (one per "
              f"approximated candidate); shared-memory body "
              f"{launches['netlist_sim_smem']}")
        split = {"finetune": sum(finetune_s),
                 "compile_and_price": sum(compile_price_s) - sum(scoring_s),
                 "approximated_scoring": sum(scoring_s)}
        split["rest"] = search_s - sum(split.values())
        print(f"[23] where the search's {search_s:.3f} s went: batched "
              f"finetune {split['finetune']:.3f} s in {len(finetune_s)} "
              f"calls; approximated scoring (passes, structural price, one "
              f"K1 launch each) {split['approximated_scoring']:.3f} s for "
              f"{n_approx} candidates; the rest of compile and price "
              f"(bespoke compile, the packed exact launches, pricing) "
              f"{split['compile_and_price']:.3f} s; baseline, GA and host "
              f"glue {split['rest']:.3f} s")
        print(f"[23] combined gain at <=5% loss: "
              f"{res['combined_gain_at_5pct']}x")
        for acc, area, delay, spec in res["pareto_front"]:
            print(f"[23]   front: acc={acc} area={area} mm2 delay={delay} "
                  f"{spec}")
        check(res["device"].startswith("cuda"), "search did not run on cuda")
        check(launches["netlist_sim"] > 0, "netlist_sim never launched")
        check(n_approx > 0 and n_approx >= n_unique,
              f"{n_approx} approximated scorings for {n_unique} "
              "approximated candidates")
        check(all(d == 1 for d in deltas), "an approximated candidate was "
              f"not scored by exactly one K1 launch: {deltas}")
        check(launches["netlist_sim_smem"] == launches["netlist_sim"],
              "a search launch took the global body")
        check(len(res["pareto_front"]) > 0, "empty Pareto front")
        for acc, area, delay, _ in res["pareto_front"]:
            check(0.0 <= acc <= 1.0 and area > 0 and delay > 0,
                  "front point out of range")

        # step 6 of the example: the chosen point approximated under 1% of
        # its logit range, its error measured by the Simulator on the card
        t1 = time.perf_counter()
        chosen = paper.chosen_point(res)
        net, compiled = circuit.compile_spec(cfg, ModelMin.from_json(chosen),
                                             epochs=60, device=dev)
        budget = approx.logit_budget(net, 0.01)
        params, anet, rep = approx.fit_budget(net, budget)
        measured = approx.measured_max_logit_error(anet, compiled, xte,
                                                   device=dev)
        acc_exact = circuit.netlist_accuracy(net, compiled, xte, yte,
                                             device=dev)
        acc_approx = circuit.netlist_accuracy(anet, compiled, xte, yte,
                                              device=dev)
        fit_s = time.perf_counter() - t1
        print(f"[23] chosen {chosen}: fit_budget at 1% ({budget} LSB): "
              f"{params}, proven decision bound {rep.bound}, proven logit "
              f"bound {rep.logit_bound}, measured max logit error "
              f"{measured} (Simulator on {dev}); area gain "
              f"{rep.area_gain:.3f}x; accuracy {acc_exact:.4f} exact, "
              f"{acc_approx:.4f} approximated [{fit_s:.3f} s]")
        check(rep.bound <= budget, "fit_budget exceeded its budget")
        check(measured <= rep.logit_bound,
              f"measured logit error {measured} over the proven bound "
              f"{rep.logit_bound}")
        out["search"] = {"seconds": search_s, "launches": launches,
                         "exact": n_exact, "approximated": n_approx,
                         "split_s": split}

    # -- 24. the Fig. 1 sweeps ---------------------------------------------
    with Phase(24, "fig1 sweeps"):
        reset_launches()
        t0 = time.perf_counter()
        fig = paper.fig1(["whitewine"], epochs=60, device=dev)
        torch.cuda.synchronize()
        fig_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        r = fig["whitewine"]
        print(f"[24] fig1 on whitewine (60 epochs): {fig_s:.3f} s, "
              f"netlist_sim launches {launches['netlist_sim']}; baseline "
              f"acc={r['baseline_acc']} area={r['baseline_area_mm2']} mm2")
        for tech, row in r["techniques"].items():
            print(f"[24]   {tech}: gain at <=5% loss "
                  f"{row['gain_at_5pct']}x, points {row['points']}")
        check([len(r["techniques"][t]["points"]) for t in
               ("quantization", "pruning", "clustering")] == [6, 5, 5],
              "fig1 sweep sizes")
        check(all(np.isfinite(row["gain_at_5pct"])
                  for row in r["techniques"].values()), "gain not finite")
        # one K1 launch per point and the baseline's
        check(launches["netlist_sim"] == 17,
              f"fig1 launched netlist_sim {launches['netlist_sim']} times")
        out["fig1"] = {"seconds": fig_s, "launches": launches}
    total = time.perf_counter() - t_start
    print(f"[22-24] phases 22 to 24: {total:.3f} s")
    out["seconds"] = total
    return out


def island_search(card: str, dev):
    """Phase 25: the fault-tolerant island search on the card (module
    docstring). Returns K1's launches and the phase's numbers."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import circuit
    from repro_torch.configs.printed_mlp import PRINTED_MLPS
    from repro_torch.core import batch_eval as BE
    from repro_torch.core import ga as GA
    from repro_torch.core import minimize as MZ
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.obs import metrics as MT
    from repro_torch.obs import prof as PF
    from repro_torch.obs import report
    from repro_torch.obs import trace as TR
    from repro_torch.search import (EvalFault, FaultHarness, FaultPlan,
                                    IslandConfig, PreemptedError,
                                    SearchConfig, SearchRuntime,
                                    inject_eval_faults)

    cfg = PRINTED_MLPS["whitewine"]
    scfg = SearchConfig(
        n_layers=len(cfg.layer_dims) - 1, rounds=4,
        ga=GA.GAConfig(population=8, seed=0, input_bits=cfg.input_bits),
        islands=IslandConfig(n_islands=2, migration_every=2, migrants=1),
        checkpoint_every=1)
    epochs = 60
    # every spec that reaches _compile_and_price paid a real finetune
    evaluated = []
    compile_price = BE._compile_and_price

    def counting(params_pop, specs, *a, **kw):
        evaluated.extend(s.to_json() for s in specs)
        return compile_price(params_pop, specs, *a, **kw)

    def evaluator(path, quarantine=None):
        cache = BE.EvalCache(path)
        return BE.make_batch_evaluator(cfg, epochs=epochs, cache=cache,
                                       quarantine=quarantine,
                                       device="cuda"), cache

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {}
    with Phase(25, "island search"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        BE._compile_and_price = counting
        reset_launches()
        PF.reset()
        MT.REGISTRY.reset()
        try:
            # A: uninterrupted, traced
            be, cache = evaluator(tmp / "a.json")
            with TR.capture(tmp / "a.jsonl"):
                res_a, a_s = timed(lambda: SearchRuntime(
                    scfg, batch_evaluate=be, eval_cache=cache,
                    ckpt_root=tmp / "ckpt_a").run())
            evaluated_a, evaluated[:] = list(evaluated), []
            hist = MT.snapshot()["histograms"]
            MT.REGISTRY.reset()
            # B: its own cache, preempted after its second round, resumed
            # by a new runtime with a new evaluator and cache handle
            be, cache = evaluator(tmp / "b.json")
            with TR.capture(tmp / "b.jsonl"):
                t0 = time.perf_counter()
                try:
                    SearchRuntime(scfg, batch_evaluate=be, eval_cache=cache,
                                  ckpt_root=tmp / "ckpt_b",
                                  harness=FaultHarness(FaultPlan(
                                      preempt_at=1))).run()
                    fail("run B was not preempted")
                except PreemptedError:
                    pass
                b_pre_s = time.perf_counter() - t0
                before, evaluated[:] = list(evaluated), []
                be, cache = evaluator(tmp / "b.json")
                rt, resume_s = timed(lambda: SearchRuntime.resume(
                    scfg, tmp / "ckpt_b", batch_evaluate=be,
                    eval_cache=cache))
                check(rt.fleet.round == 2, f"B resumed at round "
                      f"{rt.fleet.round}, not 2")
                res_b, b_post_s = timed(rt.run)
            after, evaluated[:] = list(evaluated), []
            MT.REGISTRY.reset()
            # C: island 1 dies in round 1, one spec of island 0 fails
            # every attempt and is quarantined
            bad = GA.init_ga_state(scfg.n_layers, scfg.ga).population[0]
            quarantine = []
            be, cache = evaluator(tmp / "c.json", quarantine)
            harness = FaultHarness(FaultPlan(kill_island={1: 1}))
            with TR.capture(tmp / "c.jsonl"), inject_eval_faults(
                    [EvalFault(spec_json=bad.to_json(), fail_attempts=2)]):
                res_c, c_s = timed(lambda: SearchRuntime(
                    scfg, batch_evaluate=be, eval_cache=cache,
                    harness=harness, quarantine=quarantine).run())
            recs, damaged = TR.read_trace(tmp / "a.jsonl")
            recs_b, _ = TR.read_trace(tmp / "b.jsonl")
        finally:
            BE._compile_and_price = compile_price
        search_launches = dict(LAUNCHES)

        print(f"[25] {card}: run A (uninterrupted) {a_s:.3f} s, "
              f"{len(res_a.evaluations)} evaluations, "
              f"{len(evaluated_a)} specs finetuned, front "
              f"{len(res_a.front_specs)}")
        print(f"[25] run B: {b_pre_s:.3f} s to its preemption after round 2 "
              f"({len(before)} specs finetuned), resume {resume_s:.3f} s, "
              f"then {b_post_s:.3f} s to the end ({len(after)} specs "
              f"finetuned)")
        print(f"[25] run C (island 1 killed in round 1, one spec failing "
              f"every attempt): {c_s:.3f} s, generations "
              f"{[st.generation for st in res_c.islands]}, quarantined "
              f"{[(q.stage, q.error) for q in res_c.quarantined]}")
        wm, wb = hist.get("ckpt.write_ms", {}), hist.get(
            "ckpt.write_bytes", {})
        print(f"[25] run A's {wm.get('count', 0)} checkpoints: write "
              f"{wm.get('sum', 0.0) / max(wm.get('count', 1), 1):.3f} ms "
              f"mean ({wm.get('min')}-{wm.get('max')} ms), "
              f"{wb.get('min')}-{wb.get('max')} bytes")
        spans = [r for r in recs if r.get("kind") == "span"
                 and r["name"] == "eval.finetune"]
        finetune_s = sum(float(r.get("dur", 0.0)) for r in spans)
        first_s = sum(float(r.get("dur", 0.0)) for r in spans
                      if r["attrs"].get("first"))
        # B dispatches keys A already captured: no FLOP counting in it
        b_s = b_pre_s + resume_s + b_post_s
        finetune_b_s = sum(float(r.get("dur", 0.0)) for r in recs_b
                           if r.get("kind") == "span"
                           and r["name"] == "eval.finetune")
        print(f"[25] run A's finetune {finetune_s:.3f} s of {a_s:.3f} s, "
              f"{finetune_s / a_s:.1%} of the wall time ({first_s:.3f} s of "
              f"it in first dispatches of a key, whose FLOPs "
              f"FlopCounterMode counts); run B's {finetune_b_s:.3f} s of "
              f"{b_s:.3f} s, {finetune_b_s / b_s:.1%}; K1 launches in "
              f"runs A, B and C {search_launches['netlist_sim']} "
              f"(shared-memory body {search_launches['netlist_sim_smem']})")
        k1_ms = [float(r["attrs"]["device_ms"]) for r in recs
                 if r.get("kind") == "span"
                 and r["name"] == "kernels.netlist_sim.smem"]
        print(f"[25] run A's {len(k1_ms)} K1 dispatches: CUDA-event "
              f"{min(k1_ms, default=0):.4f}-{max(k1_ms, default=0):.4f} ms "
              f"each, {sum(k1_ms):.4f} ms in all (a dispatch's events also "
              f"hold the launch's host gap)")
        text = report.render(recs, damaged, "run A's trace")
        print("[25] the port's report of run A:")
        print(text)

        # -- checks ------------------------------------------------------
        check(damaged == 0, "run A's trace has damaged lines")
        check([s.to_json() for s in res_b.front_specs]
              == [s.to_json() for s in res_a.front_specs],
              "B's front differs from A's")
        check(res_b.front_objectives.tobytes()
              == res_a.front_objectives.tobytes(),
              "B's front objectives differ from A's")
        check(res_b.evaluations == res_a.evaluations,
              "B's evaluations differ from A's")
        check(not set(before) & set(after),
              f"B re-evaluated {len(set(before) & set(after))} specs after "
              "its resume")
        check(sorted(before + after) == sorted(evaluated_a),
              "B finetuned other specs than A")
        check(res_c.islands[0].generation == scfg.rounds
              and res_c.islands[1].generation == 1
              and harness.log == [("kill", 1, 1)],
              "C's survivor did not finish, or the kill went wrong")
        check([q.spec_json for q in res_c.quarantined] == [bad.to_json()],
              "the failing spec is not quarantined on C's result")
        check(search_launches["netlist_sim"] > 0
              and search_launches["netlist_sim_smem"]
              == search_launches["netlist_sim"],
              f"{search_launches['netlist_sim']} K1 launches in the runs, "
              f"{search_launches['netlist_sim_smem']} through the "
              "shared-memory body")
        ex = report.executables(recs)
        sites = {e["site"] for e in ex}
        check({"eval.finetune", "kernels.netlist_sim.smem"} <= sites,
              f"run A's report lists {sorted(sites)}")
        check(all(e.get("device_ms", 0.0) > 0 for e in ex
                  if e["site"] in ("eval.finetune",
                                   "kernels.netlist_sim.smem")),
              "an executable of run A has no CUDA-event time")
        k1_compiles = [(e["compiles"], e["compile_s"]) for e in ex
                       if e["site"] == "kernels.netlist_sim.smem"
                       and e["compiles"]]
        check(len(k1_compiles) == 1 and k1_compiles[0][0] == 1
              and abs(k1_compiles[0][1]
                      - build.BUILD_INFO["netlist_sim"]["seconds"]) < 1e-3,
              f"K1's nvcc build is not one compile of run A: {k1_compiles}")
        check(all(e["compiles"] <= 1 for e in ex)
              and "0 key(s) recompiled" in text,
              "run A recompiled a key")
        # the netlist-exact accuracy of A's front against integer_forward
        _, _, xte, yte = MZ.dataset_for(cfg)
        for spec in res_a.front_specs:
            net, compiled = circuit.compile_spec(cfg, spec, epochs=epochs,
                                                 device=dev)
            acc_net = circuit.netlist_accuracy(net, compiled, xte, yte,
                                               device=dev)
            _, cls = MZ.integer_forward(compiled,
                                        MZ.quantize_inputs(compiled, xte))
            check(acc_net == float(np.mean(cls == yte)),
                  f"{spec.to_json()}: netlist-exact accuracy != integer "
                  "forward")
        print(f"[25] all {len(res_a.front_specs)} points of A's front: "
              f"netlist-exact accuracy == integer_forward's")
        launches = dict(LAUNCHES)
        print(f"[25] K1 launches in phase 25, the front's checks included: "
              f"{launches['netlist_sim']} (shared-memory body "
              f"{launches['netlist_sim_smem']})")
        check(launches["netlist_sim_smem"] == launches["netlist_sim"],
              "a K1 launch of phase 25 took the global body")
        out = {"launches": launches, "search_launches": search_launches,
               "a_s": a_s, "b_pre_s": b_pre_s,
               "resume_s": resume_s, "b_post_s": b_post_s, "c_s": c_s}
    return out


def lm_training(card: str, dev):
    """Phases 26-27: K5's and K6's backward kernels against their plain
    versions and autograd on the card, then qwen3-0.6b trained at full
    width and depth through ``repro_torch.launch.train`` (uninterrupted,
    checkpointed and resumed, with QAT), and falcon-mamba-7b at full width
    and 4 of its 64 layers. Returns the backward kernels' entries of the
    ``{"kernels": [...]}`` line and the training numbers."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import Segment
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.kernels.flash_attention import ops as FAO
    from repro_torch.kernels.flash_attention.ops import bwd_cost as fa_bwd_cost
    from repro_torch.kernels.ssm_scan.ops import bwd_cost as ssm_bwd_cost
    from repro_torch.launch import train as LT
    from repro_torch.nn import attention as A
    from repro_torch.nn import transformer as T
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.train import losses
    from repro_torch.train import train_state as TS
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             adamw_update_, tree_leaves,
                                             tree_unflatten)

    gen = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    # -- 26. the backward kernels against their plain versions ------------
    fa_err, fa_share, ssm_err, ssm_share = 0.0, 0.0, 0.0, 0.0
    wide_ms = {}
    with Phase(26, "flash_attention and ssm_scan backward vs plain"):
        for name, (B, Tq, H, KV, hd, window, cap, dname) in \
                BWD_CASES.items():
            dt = getattr(torch, dname)
            q, do = randn((B, Tq, H, hd), dt), randn((B, Tq, H, hd), dt)
            k, v = randn((B, Tq, KV, hd), dt), randn((B, Tq, KV, hd), dt)
            kw = dict(causal=True, window=window, softcap=cap)
            reset_launches()
            o, lse = FA.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            lse_plain = FA.flash_attention_lse_plain(q, k, v, **kw)
            lse_err, _, lse_ok = _within(
                lse, lse_plain,
                FA.flash_attention_lse_tolerance(q, k, lse_plain,
                                                 softcap=cap))
            check(lse_ok, f"flash_attention's lse disagrees on {name}")
            wgmma = FA.takes_wgmma_bwd(q, k, v, o, do)
            check(wgmma == (dt == torch.bfloat16
                            and hd in FAO.WGMMA_BWD_HEAD_DIMS),
                  f"flash_attention_bwd {name}: takes_wgmma_bwd {wgmma}")
            split = FA.bwd_head_split(Tq, B, H, KV, sms) \
                if wgmma and hd > 128 else 1
            got = FA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            check(LAUNCHES["flash_attention_bwd"] == 1
                  and LAUNCHES["flash_attention_bwd_wgmma"] == int(wgmma),
                  f"flash_attention_bwd {name}: launches {dict(LAUNCHES)}")
            again = FA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {name} is not bitwise repeatable")
            del again
            ref = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
            tols = FA.flash_attention_bwd_tolerance(q, k, v, o, do, lse,
                                                    ref, **kw)
            line = []
            for gname, a, b, t in zip(("dq", "dk", "dv"), got, ref, tols):
                err, share, ok = _within(a, b, t)
                fa_err, fa_share = max(fa_err, err), max(fa_share, share)
                line.append(f"{gname} {err:.3e} ({share:.3f} of the bound)")
                check(ok and bool(torch.isfinite(a).all()),
                      f"flash_attention_bwd disagrees on {name} {gname}")
            del ref, tols
            # through autograd: K5's forward with lse, then this kernel
            qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
            out = FA.flash_attention(qq, kk, vv, **kw)
            check(out.grad_fn is not None, f"{name}: K5's output has no "
                  "grad_fn under autograd")
            out.backward(do)
            check(all(torch.equal(x.grad, g)
                      for x, g in zip((qq, kk, vv), got)),
                  f"{name}: autograd's gradients differ from the kernel's")
            extra = ""
            if dt == torch.float32:
                # autograd of the plain forward, the gradient the reference
                # differentiates its jnp attention for
                qp, kp, vp = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                FA.flash_attention_plain(qp, kp, vp, **kw).backward(do)
                tols = FA.flash_attention_bwd_tolerance(
                    q, k, v, o, do, lse, (qp.grad, kp.grad, vp.grad), **kw)
                shares = []
                for gname, a, b, t in zip(("dq", "dk", "dv"), got,
                                          (qp.grad, kp.grad, vp.grad), tols):
                    err, share, ok = _within(a, b, t)
                    shares.append(share)
                    check(ok, f"flash_attention_bwd {name} {gname} differs "
                          "from autograd of the plain forward")
                extra = (f"; against autograd of the plain forward, largest "
                         f"share of the bound {max(shares):.3f}")
            if wgmma and hd > 128:
                # the two-warpgroup body's device time against its bound
                ms = _graph_ms(lambda: FA.flash_attention_bwd(
                    q, k, v, o, do, lse, **kw), [()], reps=5)
                flops, nbytes = fa_bwd_cost(B, Tq, Tq, H, KV, hd, 2,
                                            causal=True, window=window)
                bound = max(nbytes / HBM_BYTES_PER_S,
                            flops / BF16_TENSOR_FLOPS) * 1e3
                wide_ms[name] = dict(ms=ms, bound_ms=bound, split=split)
                extra += (f"; {ms:.4f} ms device (CUDA graph), bound "
                          f"{bound:.5f} ms, {ms / bound:.2f}x")
            body = ("CUDA-core" if not wgmma else "wgmma" if hd <= 128
                    else f"two-warpgroup wgmma (heads split over {split} "
                         f"blocks)" if split > 1 else "two-warpgroup wgmma")
            print(f"[26] flash_attention_bwd {name} B={B} T={Tq} H={H} "
                  f"KV={KV} hd={hd} window={window} softcap={cap} "
                  f"{str(dt)[6:]}, {body} body: lse max abs "
                  f"err {lse_err:.3e}; max abs err " + ", ".join(line)
                  + "; a second call equal to the bit" + extra)
            del q, k, v, o, do, lse, got, qq, kk, vv, out

        # K6's backward at falcon-mamba-7b's width
        cfg_m = ARCHS["falcon-mamba-7b"]
        di, Nm = cfg_m.ssm.expand * cfg_m.d_model, cfg_m.ssm.d_state
        Bs, Ts = FALCON_TRAIN[:2]
        u, dtm, Bm, Cm, Am, Dm = ssm_inputs(gen, Bs, Ts, di, Nm,
                                            torch.bfloat16, dev)
        dy = randn((Bs, Ts, di), torch.bfloat16)
        # the forward as autograd runs it stores the chunk-start states and
        # writes the y it writes without them
        y_st, states = SS.ssm_scan_with_states(u, dtm, Bm, Cm, Am, Dm)
        check(torch.equal(y_st, SS.ssm_scan(u, dtm, Bm, Cm, Am, Dm)),
              "ssm_scan's y differs when it stores its states")
        del y_st
        reset_launches()
        got = SS.ssm_scan_bwd(u, dtm, Bm, Cm, Am, Dm, dy, states)
        torch.cuda.synchronize()
        check(LAUNCHES["ssm_scan_bwd"] == 1 and LAUNCHES["ssm_scan"] == 0,
              f"ssm_scan_bwd: launches {dict(LAUNCHES)}")
        ref = SS.ssm_scan_bwd_plain(u, dtm, Bm, Cm, Am, Dm, dy)
        tols = SS.ssm_scan_bwd_tolerance(u, dtm, Bm, Cm, Am, Dm, dy, ref)
        line = []
        for gname, a, b, t in zip(("du", "ddt", "dB_", "dC_", "dA", "dD"),
                                  got, ref, tols):
            err, share, ok = _within(a, b, t)
            ssm_err, ssm_share = max(ssm_err, err), max(ssm_share, share)
            line.append(f"{gname} {err:.3e} ({share:.3f})")
            check(ok and bool(torch.isfinite(a).all()),
                  f"ssm_scan_bwd disagrees on {gname}")
        again = SS.ssm_scan_bwd(u, dtm, Bm, Cm, Am, Dm, dy, states)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "ssm_scan_bwd is not bitwise repeatable")
        print(f"[26] ssm_scan_bwd B={Bs} T={Ts} d={di} N={Nm} bf16, the "
              f"forward's chunk-start states: max abs err (share of the "
              f"bound) " + ", ".join(line) + "; a second call equal to the "
              "bit")
        del ref, tols, again

        # times at qwen3_train: three input sets (64 MB each), more than the
        # 50 MB L2 holds, rotated as in `_rotating_ms`
        B, Tq, H, KV, hd = BWD_CASES["qwen3_train"][:5]
        fa_sets = []
        for _ in range(3):
            q, do = randn((B, Tq, H, hd), torch.bfloat16), \
                randn((B, Tq, H, hd), torch.bfloat16)
            k, v = randn((B, Tq, KV, hd), torch.bfloat16), \
                randn((B, Tq, KV, hd), torch.bfloat16)
            o, lse = FA.flash_attention_with_lse(q, k, v)
            check(FA.takes_wgmma_bwd(q, k, v, o, do), "qwen3_train's "
                  "backward does not take the wgmma body")
            fa_sets.append((q, k, v, o, do, lse))
        fa_eager_ms = _rotating_ms(FA.flash_attention_bwd, fa_sets,
                                   reps=21)
        fa_ms = _graph_ms(FA.flash_attention_bwd, fa_sets, reps=21)
        cycle = itertools.cycle(fa_sets)
        parts = kernel_ms_by_name(
            lambda: FA.flash_attention_bwd(*next(cycle)), 12,
            ("delta_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel"))
        check(None not in parts.values(), f"the profiler recorded no launch "
              f"of some of K5's backward kernels: {parts}")
        parts_sum = sum(parts.values())
        dq_share = parts["dq_wgmma_kernel"] / parts_sum
        fa_plain_ms = event_ms(
            lambda: FA.flash_attention_bwd_plain(*fa_sets[0]),
            reps=3, warmup=1)
        fa_flops, fa_bytes = fa_bwd_cost(B, Tq, Tq, H, KV, hd, 2)
        fa_bytes_ms = fa_bytes / HBM_BYTES_PER_S * 1e3
        fa_ops_ms = fa_flops / BF16_TENSOR_FLOPS * 1e3
        fa_bound = max(fa_bytes_ms, fa_ops_ms)

        def k5_fwd_bwd(q, k, v, o, do, lse):
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            FA.flash_attention(qq, kk, vv).backward(do)

        def sdpa_fwd_bwd(q, k, v, o, do, lse):
            qq, kk, vv = (x.detach().transpose(1, 2).requires_grad_(True)
                          for x in (q, k, v))
            F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=True, enable_gqa=True).backward(
                    do.transpose(1, 2))

        k5_fb_ms = _rotating_ms(k5_fwd_bwd, fa_sets, reps=12)
        sdpa_fb_ms = _rotating_ms(sdpa_fwd_bwd, fa_sets, reps=12)
        # SDPA's backward alone, measured as K5's is: each set's forward
        # once on a side stream, then torch.autograd.grad of its output
        # captured in a CUDA graph on that stream, the sets rotated
        sdpa_stream = torch.cuda.Stream()
        sdpa_stream.wait_stream(torch.cuda.current_stream())
        sdpa_sets = []
        with torch.cuda.stream(sdpa_stream):
            for q, k, v, o, do, lse in fa_sets:
                ins = tuple(x.detach().transpose(1, 2).requires_grad_(True)
                            for x in (q, k, v))
                out = F.scaled_dot_product_attention(*ins, is_causal=True,
                                                     enable_gqa=True)
                sdpa_sets.append((out, ins, do.transpose(1, 2)))
        torch.cuda.current_stream().wait_stream(sdpa_stream)

        def sdpa_bwd(out, ins, do_s):
            return torch.autograd.grad(out, ins, do_s, retain_graph=True)

        got_s = sdpa_bwd(*sdpa_sets[0])
        want_s = FA.flash_attention_bwd(*fa_sets[0])
        check(all(_rel(a.transpose(1, 2), b) < 0.02
                  for a, b in zip(got_s, want_s)),
              "SDPA's backward yardstick computes another function")
        del got_s, want_s
        sdpa_bwd_ms = _graph_ms(sdpa_bwd, sdpa_sets, reps=21,
                                stream=sdpa_stream)
        with torch.cuda.stream(sdpa_stream):
            sdpa_bwd_eager_ms = _rotating_ms(sdpa_bwd, sdpa_sets, reps=21)
        del sdpa_sets
        print(f"[26] {card}: flash_attention_bwd B={B} T=S={Tq} H={H} KV={KV} "
              f"hd={hd} causal bf16, wgmma body, 3 input sets rotated past "
              f"the L2: kernel {fa_ms:.4f} ms device (CUDA graph), "
              f"{fa_eager_ms:.4f} ms eager; plain {fa_plain_ms:.4f} ms, bound "
              f"{fa_bound:.5f} ms ({fa_flops} flops at the bf16 tensor-core "
              f"rate {fa_ops_ms:.5f} ms, {fa_bytes} bytes "
              f"{fa_bytes_ms:.5f} ms); {fa_ms / fa_bound:.1f}x the bound; "
              f"SDPA's backward alone (torch.autograd.grad of its output) "
              f"{sdpa_bwd_ms:.4f} ms device (CUDA graph), "
              f"{sdpa_bwd_eager_ms:.4f} ms eager; forward + backward through "
              f"autograd, eager: K5 {k5_fb_ms:.4f} ms, "
              f"F.scaled_dot_product_attention {sdpa_fb_ms:.4f} ms")
        print(f"[26] {card}: flash_attention_bwd's kernels (torch.profiler, "
              f"device ms a call): " + ", ".join(
                  f"{n} {t:.4f} ({t / parts_sum:.3f})"
                  for n, t in parts.items())
              + f"; the dq kernel {dq_share:.3f} of the backward ("
              f"{'above' if dq_share > 0.4 else 'not above'} 0.4)")
        del q, k, v, o, do, lse, fa_sets, cycle
        # K6 at falcon-mamba-7b's training width: two input sets (400 MB
        # each with the states), rotated
        ssm_sets = [(u, dtm, Bm, Cm, Am, Dm, dy, states)]
        ins = ssm_inputs(gen, Bs, Ts, di, Nm, torch.bfloat16, dev)
        ssm_sets.append((*ins, randn((Bs, Ts, di), torch.bfloat16),
                         SS.ssm_scan_with_states(*ins)[1]))
        del ins
        ssm_ms = _rotating_ms(SS.ssm_scan_bwd, ssm_sets, reps=20)
        ssm_graph_ms = _graph_ms(SS.ssm_scan_bwd, ssm_sets, reps=20)
        # the forward as autograd runs it (storing the states) and as
        # prefill runs it, at this shape
        fwd_sets = [a[:6] for a in ssm_sets]
        ssm_fwd_states_ms = _graph_ms(SS.ssm_scan_with_states, fwd_sets,
                                      reps=20)
        ssm_fwd_ms = _graph_ms(SS.ssm_scan, fwd_sets, reps=20)
        ssm_plain_ms = event_ms(
            lambda: SS.ssm_scan_bwd_plain(u, dtm, Bm, Cm, Am, Dm, dy),
            reps=1, warmup=1)
        ssm_ops, ssm_bytes, ssm_exps = ssm_bwd_cost(Bs, Ts, di, Nm, 2)
        check(ssm_bytes == sum(a.numel() * a.element_size()
                               for a in (u, dtm, Bm, Cm, Am, Dm, dy))
              + sum(a.numel() * a.element_size() for a in got),
              "ssm_scan_bwd's byte count differs from its inputs and "
              "outputs")
        ssm_bytes_ms = ssm_bytes / HBM_BYTES_PER_S * 1e3
        ssm_ops_ms = ssm_ops / SCALAR_OPS_PER_S * 1e3
        exp_floor_ms = ssm_exps / (EXP2_PER_CLOCK_PER_SM * sms * clock_hz) \
            * 1e3
        ssm_bound = max(ssm_bytes_ms, ssm_ops_ms, exp_floor_ms)
        ssm_bound_by = "bytes" if ssm_bound == ssm_bytes_ms else "operations"
        print(f"[26] {card}: ssm_scan_bwd B={Bs} T={Ts} d={di} N={Nm} bf16, "
              f"2 input sets rotated: kernel {ssm_ms:.4f} ms eager "
              f"({ssm_graph_ms:.4f} ms device, CUDA graph), plain "
              f"{ssm_plain_ms:.4f} ms, bound "
              f"{ssm_bound:.5f} ms, the largest of: {ssm_bytes} bytes "
              f"{ssm_bytes_ms:.5f} ms; {ssm_ops} float32 operations "
              f"{ssm_ops_ms:.5f} ms; exp floor {exp_floor_ms:.5f} ms "
              f"({ssm_exps} exps); {ssm_graph_ms / ssm_bound:.1f}x the "
              f"bound (device time)")
        print(f"[26] {card}: ssm_scan forward at B={Bs} T={Ts} d={di} N={Nm} "
              f"bf16 (CUDA graph): storing the chunk-start states for the "
              f"backward {ssm_fwd_states_ms:.4f} ms, without them "
              f"{ssm_fwd_ms:.4f} ms "
              f"({ssm_fwd_states_ms / ssm_fwd_ms - 1:+.3f})")
        del ssm_sets, fwd_sets
        del u, dtm, Bm, Cm, Am, Dm, dy, got, states
    gc.collect()
    torch.cuda.empty_cache()

    # -- 27. training at full width -----------------------------------------
    # one bf16 rounding of the residual stream in each of 28 layers on the
    # forward and again on the backward, added up without amplification
    grad_bound = 2 * LM_REL_BOUND
    numbers = {}
    with Phase(27, "qwen3-0.6b and falcon-mamba-7b training"):
        cfg = ARCHS["qwen3-0.6b"]
        opt = AdamWConfig(lr=3e-4, total_steps=4, warmup_steps=1)
        Bt, Tt = QWEN3_TRAIN
        state = TS.init_state(torch.Generator(device=dev).manual_seed(0),
                              cfg, opt, device=dev)
        n_params = T.param_count(state.params)
        check(n_params == QWEN3_PARAMS,
              f"qwen3-0.6b has {n_params} parameters")
        tokens = torch.randint(0, cfg.vocab_size, (Bt, Tt), generator=gen,
                               device=dev)

        def grads(params):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            logits, aux = T.forward(tree_unflatten(params, leaves),
                                    {"tokens": tokens}, cfg, remat=True)
            loss = losses.next_token_loss(logits, tokens, aux=aux)
            del logits
            return float(loss.detach()), torch.autograd.grad(loss, leaves)

        reset_launches()
        loss_k, g_k = grads(state.params)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        check(launches["flash_attention"] == 2 * cfg.num_layers
              and launches["flash_attention_wgmma"] == 2 * cfg.num_layers
              and launches["flash_attention_bwd"] == cfg.num_layers
              and launches["flash_attention_bwd_wgmma"] == cfg.num_layers,
              f"one step's gradient launched {launches}")
        A.flash_attention = FA.flash_attention_plain
        try:
            loss_p, g_p = grads(state.params)
        finally:
            A.flash_attention = FA.flash_attention
        norm_k = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_k)))
        norm_p = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_p)))
        leaf_rel = [abs(float(a.float().norm()) - float(b.float().norm()))
                    / max(float(b.float().norm()), 1e-30)
                    for a, b in zip(g_k, g_p)]
        diff_rel = [float((a.float() - b.float()).norm())
                    / max(float(b.float().norm()), 1e-30)
                    for a, b in zip(g_k, g_p)]
        paths = tree_leaves(T.map_tree(lambda p, _: "/".join(map(str, p)),
                                       state.params))
        worst = int(np.argmax(leaf_rel))
        print(f"[27] qwen3-0.6b: {n_params} parameters; one gradient at "
              f"B={Bt} T={Tt}, remat on: launches {launches}; loss {loss_k:.6f}"
              f" (plain K5 {loss_p:.6f}); global gradient norm {norm_k:.6f} "
              f"(plain {norm_p:.6f}, relative difference "
              f"{abs(norm_k - norm_p) / norm_p:.3e}, bound {LM_REL_BOUND:.3e})"
              f"; largest relative difference of a leaf's norm "
              f"{leaf_rel[worst]:.3e} at {paths[worst]} (bound "
              f"{grad_bound:.3e}); relative L2 of the leaves' differences: "
              f"median {float(np.median(diff_rel)):.3e}, largest "
              f"{max(diff_rel):.3e}")
        check(abs(norm_k - norm_p) <= LM_REL_BOUND * norm_p,
              "the global gradient norm through the kernels differs from the "
              "plain version's beyond the bound")
        check(max(leaf_rel) <= grad_bound, "a leaf's gradient norm through "
              "the kernels differs from the plain version's beyond the bound")
        del g_k, g_p, state
        gc.collect()
        torch.cuda.empty_cache()

        common = ["--arch", "qwen3-0.6b", "--seq-len", str(Tt),
                  "--global-batch", str(Bt), "--log-every", "1",
                  "--lr", "3e-4"]
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_a = LT.main(common + ["--steps", "4"])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        numbers["launches_qwen3"] = launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = 4
        check(launches["flash_attention"] == 2 * cfg.num_layers * steps
              and launches["flash_attention_bwd"] == cfg.num_layers * steps
              and launches["flash_attention_wgmma"]
              == launches["flash_attention"]
              and launches["flash_attention_bwd_wgmma"]
              == launches["flash_attention_bwd"],
              f"4 training steps launched {launches}")
        hist_a = run_a["history"]
        check([r["step"] for r in hist_a] == [0, 1, 2, 3]
              and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                      for r in hist_a), f"run A's history {hist_a}")
        step_s = [r["step_s"] for r in hist_a]
        steady = float(np.median(step_s[1:]))
        print(f"[27] {card}: qwen3-0.6b, 4 steps of B={Bt} T={Tt} through "
              f"launch.train: losses " + ", ".join(
                  f"{r['loss']:.6f}" for r in hist_a)
              + f"; step s {step_s}; steady {steady:.4f} s a step, "
              f"{Bt * Tt / steady:.0f} tokens/s; wall {wall_a:.3f} s with set-"
              f"up; peak device memory {peak:.2f} GiB with the donated "
              f"update (16.80 GiB with the functional one); launches "
              f"{launches} "
              f"({launches['flash_attention'] // steps} K5 forward and "
              f"{launches['flash_attention_bwd'] // steps} backward a step, "
              f"{launches['flash_attention_bwd_wgmma'] // steps} of them "
              f"through the backward's wgmma body)")
        trainer = run_a["trainer"]
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in trainer.pipeline.batch_at(0).items()}
        st = trainer.state
        wall_s, busy_s, n_k = device_busy(lambda: trainer.step_fn(st, batch))
        print(f"[27] {card}: one qwen3-0.6b training step: wall {wall_s:.4f}"
              f" s, device busy {busy_s:.4f} s in {n_k} kernels, busy share "
              f"{busy_s / wall_s:.3f}")
        # the update alone on run A's state and one gradient: the memory
        # each form allocates above them, and the same bits from both
        _, g = grads(st.params)
        with torch.no_grad():
            g = tree_unflatten(st.params, list(g))
            update_gib = []
            for update in (adamw_update, adamw_update_):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                new = update(opt, g, st.opt, st.params)
                torch.cuda.synchronize()
                update_gib.append(
                    (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
                if update is adamw_update:
                    functional = new
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(functional[:2]), tree_leaves(new[:2])))
        del g, functional, new
        print(f"[27] {card}: the AdamW update of qwen3-0.6b's "
              f"{QWEN3_PARAMS} parameters on top of the state and the "
              f"gradients: functional {update_gib[0]:.3f} GiB, donated "
              f"{update_gib[1]:.3f} GiB; the same bits: {same}")
        check(same, "the donated update's bits differ from the functional "
              "one's")
        numbers["qwen3"] = dict(step_s=steady, tokens_per_s=Bt * Tt / steady,
                                peak_gib=peak, busy_share=busy_s / wall_s,
                                update_gib=update_gib)
        del trainer, st, run_a, batch
        gc.collect()
        torch.cuda.empty_cache()

        class PreemptedAfterTwo(LT.Trainer):
            """The launcher's trainer, told to stop after its second step
            as its SIGTERM handler tells it (finish the step, checkpoint,
            stop), so both runs keep the 4-step schedule."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                inner, done = self.step_fn, []

                def step_fn(state, batch):
                    out = inner(state, batch)
                    done.append(1)
                    if len(done) == 2:
                        self.request_preemption()
                    return out
                self.step_fn = step_fn

        with tempfile.TemporaryDirectory(dir=ROOT / "src" / "repro_torch"
                                         / "_build") as ckpt:
            LT.Trainer = PreemptedAfterTwo
            try:
                t0 = time.perf_counter()
                first = LT.main(common + ["--steps", "4", "--ckpt-dir",
                                          ckpt])
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
            finally:
                LT.Trainer = PreemptedAfterTwo.__bases__[0]
            check(first["preempted"] and first["last_step"] == 1,
                  f"the preempted run stopped at {first['last_step']}")
            del first
            gc.collect()
            t0 = time.perf_counter()
            second = LT.main(common + ["--steps", "4", "--ckpt-dir", ckpt])
            torch.cuda.synchronize()
            t_second = time.perf_counter() - t0
            hist_b = second["history"]
            del second
        check([r["step"] for r in hist_b] == [2, 3],
              f"the resumed run logged {hist_b}")
        pairs = [(a["loss"], b["loss"]) for a, b in zip(hist_a[2:], hist_b)]
        bit_equal = all(a == b for a, b in pairs)
        print(f"[27] qwen3-0.6b: 2 steps, preempted, a checkpoint "
              f"({t_first:.3f} s), then a new run resumed from it for steps 2-3 "
              f"({t_second:.3f} s): losses " + ", ".join(
                  f"{b:.6f} (uninterrupted {a:.6f})" for a, b in pairs)
              + f"; bit-equal: {bit_equal}")
        check(all(abs(a - b) <= 2e-3 * abs(a) for a, b in pairs),
              "the resumed run's losses differ from the uninterrupted run's "
              "beyond rtol 2e-3")
        gc.collect()
        torch.cuda.empty_cache()

        reset_launches()
        qat = LT.main(common + ["--steps", "1", "--qat-bits", "8"])
        torch.cuda.synchronize()
        check(np.isfinite(qat["final_loss"])
              and LAUNCHES["flash_attention_bwd"] == cfg.num_layers
              and LAUNCHES["flash_attention_bwd_wgmma"] == cfg.num_layers,
              f"the QAT step: loss {qat['final_loss']}, launches "
              f"{dict(LAUNCHES)}")
        print(f"[27] qwen3-0.6b, one step with --qat-bits 8: loss "
              f"{qat['final_loss']:.6f}, {qat['history'][-1]['step_s']:.4f} "
              f"s")
        del qat
        gc.collect()
        torch.cuda.empty_cache()

        # falcon-mamba-7b at full width, 4 of its 64 layers: its 7.27 B
        # parameters need about 87 GB for bf16 weights and gradients and
        # float32 AdamW moments, past the card's 80 GB
        base = ARCHS["falcon-mamba-7b"]
        layers = FALCON_TRAIN[2]
        cfg_f = dataclasses.replace(base, segments=tuple(
            Segment(s.pattern, layers) for s in base.segments))
        opt_f = AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=1)
        state = TS.init_state(torch.Generator(device=dev).manual_seed(0),
                              cfg_f, opt_f, device=dev)
        step = TS.make_train_step(cfg_f, opt_f, remat=True)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg_f.vocab_size, seq_len=Ts, global_batch=Bs))
        losses_f, times_f = [], []
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipe.batch_at(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses_f.append(float(m["loss"]))
            times_f.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        numbers["launches_falcon_mamba"] = launches
        peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches["ssm_scan_bwd"] == 3 * layers
              and launches["ssm_scan"] == 3 * 2 * layers,
              f"3 falcon-mamba-7b steps launched {launches}")
        check(all(np.isfinite(x) for x in losses_f),
              f"falcon-mamba-7b losses {losses_f}")
        print(f"[27] {card}: falcon-mamba-7b, d {base.d_model}, {layers} of "
              f"its 64 layers, {T.param_count(state.params)} parameters, 3 "
              f"steps of B={Bs} T={Ts}: losses " + ", ".join(
                  f"{x:.6f}" for x in losses_f)
              + f"; step s {[round(x, 4) for x in times_f]}; "
              f"{Bs * Ts / float(np.median(times_f[1:])):.0f} tokens/s; "
              f"peak device memory {peak_f:.2f} GiB; launches {launches}")
        numbers["falcon_mamba"] = dict(step_s=float(np.median(times_f[1:])),
                                       peak_gib=peak_f)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

    fa_entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "body": "wgmma (bf16, head_dim 64 and 128 one warpgroup a block, 192 "
                "and 256 two, dV and S^T -> P^T on one, dK and dP^T on the "
                "other, P^T through shared memory): D = rowsum(do o); dk, "
                "dv a 64-key tile over the group's heads (split over blocks "
                "where the key tiles do not fill the SMs) and query tiles "
                "fed by TMA, S^T = K Q^T and dP^T = V dO^T, dV += P^T dO "
                "and dK += dS^T Q; dq a 64-query tile over KV tiles; P "
                "recomputed from lse in the log2 domain; CUDA cores, "
                "float32, for everything else",
        "wide_cases": wide_ms,
        "launches_wgmma_body":
            numbers["launches_qwen3"]["flash_attention_bwd_wgmma"],
        "kernel_ms_by_name": parts, "eager_ms": fa_eager_ms,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87 (its "
                    "gradient: the reference differentiates its jnp "
                    "attention, src/repro/nn/attention.py)",
        "launches": numbers["launches_qwen3"]["flash_attention_bwd"],
        "max_abs_err": fa_err,
        "largest_share_of_bound": fa_share,
        "tolerance": "flash_attention_bwd_tolerance",
        "shapes": "qwen3-0.6b training B={} T=S={} H={} KV={} hd={} "
                  "causal bf16".format(*BWD_CASES["qwen3_train"][:5]),
        "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound,
        "bound_by": "bytes" if fa_bytes_ms >= fa_ops_ms else "operations",
        "library_ms": sdpa_bwd_ms, "library_eager_ms": sdpa_bwd_eager_ms,
        "library": "torch.autograd.grad of F.scaled_dot_product_attention's "
                   "output (its backward alone), device time",
        "k5_fwd_bwd_eager_ms": k5_fb_ms,
        "sdpa_fwd_bwd_eager_ms": sdpa_fb_ms}
    ssm_entry = {
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
        "body": "CUDA cores: a channel's state over 4 lanes; the "
                "forward's chunk-start states, each chunk of 16 steps "
                "rebuilt in registers and walked in reverse; u, dt, dy "
                "through a cp.async ring; dB_ and dC_ over a warp by "
                "shuffles, over the block's warps in order, block partials "
                "summed in order",
        "eager_ms": ssm_ms,
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:51 (its "
                    "gradient: the reference differentiates its jnp scan, "
                    "src/repro/nn/ssm.py:70)",
        "launches": numbers["launches_falcon_mamba"]["ssm_scan_bwd"],
        "max_abs_err": ssm_err,
        "largest_share_of_bound": ssm_share,
        "tolerance": "ssm_scan_bwd_tolerance",
        "shapes": f"falcon-mamba-7b training B={Bs} T={Ts} d={di} N={Nm} "
                  "bf16",
        "ms": ssm_graph_ms, "plain_ms": ssm_plain_ms, "bound_ms": ssm_bound,
        "bound_by": ssm_bound_by, "library_ms": None,
        "forward_with_states_ms": ssm_fwd_states_ms,
        "forward_without_states_ms": ssm_fwd_ms}
    return [fa_entry, ssm_entry], numbers


# phases 28-33: the prefill batch, the w8 decode (batch, prompt, greedy
# steps), the tokens decoded past the window in the ring wraps, the steps
# timed at full depth past the window, and the engine's waves (waves,
# prompt tokens, new tokens; ``SERVING_DECODE[0]`` requests a wave)
SERVING_PREFILL = (4, 1024)
SERVING_DECODE = (8, 16, 16)
RING_PAST_WINDOW = 64
PAST_WINDOW_STEPS = 8
ENGINE_WAVES = (3, 16, 16)
# relative L2 bounds of phases 28-33's comparisons: the prefill's last
# logits against K5's plain version ("prefill"; whisper's encoder output is
# held to its model's), the w8 decode's against K2's plain version ("w8"),
# the ring wrap's decode against the windowed forward ("ring"), each ring
# slot's k and v against the forward's at the position the slot must hold
# ("slot"), MLA's absorbed decode against the last position of a prefill
# over the same tokens ("decode"), and the dense decode's against the same
# steps on K5's plain version ("dense"). Each is about 4x the largest
# reading on an H100, which repeated to the digit from run to run; a wrong
# or stale slot, a broken cross attention or MLA is a relative L2 of order
# 1.
SERVING_BOUNDS = {
    "gemma2-2b": {"prefill": 0.028, "w8": 0.028, "ring": 0.008,
                  "slot": 0.004},
    "recurrentgemma-9b": {"prefill": 0.014, "w8": 0.015, "ring": 0.0034,
                          "slot": 0.008},
    "phi3.5-moe": {"prefill": 0.025},
    "deepseek-v2": {"prefill": 0.03, "w8": 0.034, "decode": 0.017},
    "whisper-base": {"prefill": 0.031, "w8": 0.031, "dense": 0.036},
    "llama-3.2-vision": {"prefill": 0.08, "w8": 0.092, "dense": 0.084},
}
# phi3.5-moe: the layers kept of its 32 (all 32 are 84 GB in bf16);
# deepseek-v2: its dense layer 0 and 3 of its 59 MoE layers (all 60 are
# about 440 GiB in bf16)
PHI_LAYERS = 4
DEEPSEEK_MOE_LAYERS = 3
# parameters and active parameters at these depths, as the JAX package's
# `param_count` and `active_param_count` count them
SERVING_PARAMS = {"gemma2-2b": (2614341888, 2614341888),
                  "recurrentgemma-9b": (9396408320, 9396408320),
                  "phi3.5-moe-42b-a6.6b": (5463904256, 1059885056),
                  "deepseek-v2-236b": (13302912000, 2402964480),
                  "whisper-base": (114727942, 114727942),
                  "llama-3.2-vision-11b": (10110734344, 10110734344)}


def n_mixers(cfg, mixer: str) -> int:
    """The layers of ``cfg`` whose mixer is ``mixer``."""
    return sum(s.mixer == mixer for seg in cfg.segments
               for s in seg.pattern for _ in range(seg.repeats))


def serving_steps(card: str, dev, gen, out):
    """The steps phases 28-33 share: each draws from ``gen`` and adds its
    path's K5 and K2 launches to ``out["k5"]`` and ``out["k2"]``. Returns
    them by name."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.nn import attention as A
    from repro_torch.nn import layers as L
    from repro_torch.nn import moe as M
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.train_state import make_prefill_step

    def draw(n, name, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init(gen, cfg, device=dev)
        torch.cuda.synchronize()
        counts = (T.param_count(params), T.active_param_count(params, cfg))
        print(f"[{n}] {name}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, window {cfg.window_size}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}: {counts[0]} parameters "
              f"({counts[1]} active) drawn in "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        want = SERVING_PARAMS.get(cfg.name)
        check(want is None or counts == want, f"{counts} parameters and "
              f"active parameters, not the JAX package's {want}")
        # init leaves every cross_gate at 0, where tanh(0) = 0 drops the
        # cross sublayer and no check below could see cross attention
        return T.map_tree(lambda path, t: torch.full_like(t, 0.5)
                          if "cross_gate" in path else t, params)

    def with_routes(fn, routes=None):
        """``fn()`` with every MoE layer's routing recorded, or, given
        ``routes``, replayed in order: each layer routes as the recorded
        run did, and the choices it would have made otherwise are counted.
        Returns (fn's result, the routings recorded, [other experts
        chosen, other pairs kept])."""
        route = M.route_tokens
        seen, flips = [], [0, 0]
        replay = None if routes is None else iter(routes)

        def routed(p, xf, c):
            mine = route(p, xf, c)
            if replay is None:
                seen.append(mine)
                return mine
            theirs = next(replay)
            flips[0] += int((mine["topi"] != theirs["topi"]).sum())
            flips[1] += int((mine["keep"] != theirs["keep"]).sum())
            return theirs

        M.route_tokens = routed
        try:
            return fn(), seen, flips
        finally:
            M.route_tokens = route

    def context(cfg, B):
        """Seeded stub frames (whisper) or patches (vision) at d_model in
        the model's dtype: the batch key and the tensor, or (None, None)."""
        n, key = ((cfg.encoder.num_frames, "frames") if cfg.encoder else
                  (cfg.vision.num_patches, "patches") if cfg.vision else
                  (0, None))
        if key is None:
            return None, None
        return key, torch.randn((B, n, cfg.d_model), generator=gen,
                                device=dev).to(L.torch_dtype(cfg.dtype))

    def prefill(n, name, cfg, params, *, windowed, bound,
                replay_routing=False):
        """make_prefill_step on 4 x 1024 tokens (with seeded frames or
        patches where the model takes them), K5's launches counted by the
        window each took, causal or not, and by body, timed, and held
        against the same step on K5's plain version. Each non-causal launch
        (an encoder layer's, a cross attention's) is also held element by
        element against K5's plain version on its own inputs."""
        step = make_prefill_step(cfg)
        Bp, Tp = SERVING_PREFILL
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bp, Tp),
                                         generator=gen, device=dev)}
        key, ctx = context(cfg, Bp)
        if key:
            batch[key] = ctx
        windows, causal, shares = [], [], []
        kernel = A.flash_attention

        def recording(q, k, v, **kw):
            windows.append(kw.get("window", 0))
            causal.append(kw.get("causal", True))
            o = kernel(q, k, v, **kw)
            if not causal[-1]:
                ref = FA.flash_attention_plain(q, k, v, **kw)
                shares.append(_within(o, ref, FA.flash_attention_bound(
                    q, k, v, ref, **kw))[1])
            return o

        A.flash_attention = recording
        try:
            reset_launches()
            last, routes, _ = with_routes(lambda: step(params, batch))
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        finally:
            A.flash_attention = kernel
        # each self-attention (a cross block's too) causal; each cross
        # attention and each encoder layer not
        n_causal = sum(n_mixers(cfg, m) for m in ("attn", "local", "cross"))
        n_free = n_mixers(cfg, "cross") + (cfg.encoder.num_layers
                                           if cfg.encoder else 0)
        k5 = launches["flash_attention"]
        n_win = sum(w > 0 for w in windows)
        n_c = sum(causal)
        print(f"[{n}] {name} prefill {Bp} x {Tp} tokens"
              + (f" over {tuple(ctx.shape)} {key}" if key else "")
              + f": launches {launches}; K5 windowed {n_win}, global "
              f"{k5 - n_win}; causal {n_c}, non-causal {k5 - n_c}")
        check(k5 == n_causal + n_free == len(windows),
              f"prefill launched flash_attention {k5} times, not "
              f"{n_causal + n_free}")
        check(n_c == n_causal, f"{n_c} causal K5 launches, not {n_causal}")
        if shares:
            print(f"[{n}] each non-causal K5 launch against K5's plain "
                  f"version on its inputs: largest share of the bound "
                  f"{max(shares):.3e} over {len(shares)} launches")
            check(max(shares) <= 1.0, f"a non-causal K5 launch of {name}'s "
                  f"prefill differs from the plain version beyond the bound")
        check(n_win == windowed, f"{n_win} windowed K5 launches, not "
              f"{windowed}")
        check(launches["flash_attention_wgmma"] == k5,
              f"{launches['flash_attention_wgmma']} of {k5} K5 launches "
              f"took the wgmma body")
        check(tuple(last.shape) == (Bp, cfg.vocab_size)
              and bool(torch.isfinite(last).all()),
              "prefill logits not finite or of the wrong shape")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        print(f"[{n}] {card}: {name} prefill {prefill_s:.4f} s "
              f"({Bp * Tp / prefill_s:.0f} tokens/s)")
        # K5's plain version on the same step; an MoE layer replays the
        # kernel run's routing, so that a near-tie between two experts
        # cannot flip a choice (the flips it would make are counted)
        A.flash_attention = FA.flash_attention_plain
        try:
            last_plain, _, flips = with_routes(
                lambda: step(params, batch),
                routes if replay_routing else None)
        finally:
            A.flash_attention = kernel
        rel = _rel(last, last_plain)
        agree = float((last.argmax(-1) == last_plain.argmax(-1)).float()
                      .mean())
        print(f"[{n}] last-position logits vs K5's plain version: relative "
              f"L2 {rel:.3e} (bound {bound:.3e}), max abs "
              f"{float((last - last_plain).abs().max()):.3e}, argmax "
              f"agreement {agree:.3f}"
              + (f"; routing replayed: the plain run would have chosen "
                 f"{flips[0]} other experts and kept {flips[1]} other "
                 f"pairs" if replay_routing else ""))
        check(rel <= bound, f"{name} prefill logits differ from the plain "
              f"version's beyond the bound")
        out["k5"][f"{name} prefill (phase {n})"] = k5
        return batch, routes, prefill_s

    def w8_decode(n, name, cfg, qparams, per_step, bound, enc_out=None,
                  replay_routing=False):
        """The w8 serve step at batch 8 with K2's launches counted (and
        K5's: one a cross layer a step, over ``enc_out``), the same tokens
        teacher-forced through K2's plain version (with the kernel run's
        routing replayed, for an MoE model), and the device's busy share
        over 4 steps. K2's launches at M = 8 take the decode body's mma
        path; the cross K and V projections over ``enc_out`` (two a cross
        layer a step, M = 8 x its length) the large-M body. Returns the
        step's wall and device ms."""
        serve = QS.make_quant_serve_step(cfg)
        Bd, P, G = SERVING_DECODE
        prompt = torch.randint(0, cfg.vocab_size, (Bd, P), generator=gen,
                               device=dev)

        def fresh():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            if enc_out is not None:
                st["enc_out"] = enc_out
            return st

        state = fresh()
        fed, nxt = [], None
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for t in range(P + G):
            inp = prompt[:, t:t + 1] if t < P else nxt
            fed.append(inp)
            nxt, state = serve(qparams, state, inp)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (P + G) * 1e3
        launches = dict(LAUNCHES)
        k2 = launches["quant_matmul"]
        print(f"[{n}] {name} w8 decode, batch {Bd}, {P} prompt + {G} greedy "
              f"steps: launches {launches} ({k2 / (P + G):.0f} quant_matmul "
              f"a step); {card}: {step_ms:.3f} ms a step, "
              f"{Bd / step_ms * 1e3:.1f} tokens/s")
        check(k2 == per_step * (P + G), f"quant_matmul launched {k2} times "
              f"in {P + G} steps, not {per_step} a step")
        wide = 2 * n_mixers(cfg, "cross") * (P + G)
        check(launches["quant_matmul_wgmma"] == wide,
              f"{launches['quant_matmul_wgmma']} quant_matmul launches took "
              f"the large-M body, not the {wide} cross K and V projections")
        missed = k2 - wide - launches["quant_matmul_mma"]
        check(missed == 0, f"{missed} quant_matmul launches at M = {Bd} "
              f"missed the decode body's tensor-core path")
        k5 = n_mixers(cfg, "cross") * (P + G)
        check(launches["flash_attention"] == k5, f"decode launched K5 "
              f"{launches['flash_attention']} times, not {k5}")
        check(launches["flash_attention_wgmma"] == k5, "a decode K5 launch "
              "missed the wgmma body")

        def teacher_forced():
            st = fresh()
            lg = []
            for inp in fed:
                x, st = T.decode_step(qparams, st, inp, cfg)
                lg.append(x[:, 0])
            return torch.stack(lg)

        kern, routes, _ = with_routes(teacher_forced)
        L.quant_matmul = QM.quant_matmul_ref
        try:
            plain, _, flips = with_routes(
                teacher_forced, routes if replay_routing else None)
        finally:
            L.quant_matmul = QM.quant_matmul
        rels = [_rel(kern[i], plain[i]) for i in range(P + G)]
        same = bool((torch.cat(fed[P:], 1)
                     == kern[P - 1:-1].argmax(-1).t()).all())
        print(f"[{n}] teacher-forced logits, kernel vs K2's plain version: "
              f"largest relative L2 of a step {max(rels):.3e} (bound "
              f"{bound:.3e}); the serve step's greedy tokens reproduced: "
              f"{same}" + (f"; routing replayed: the plain run would have "
                           f"chosen {flips[0]} other experts and kept "
                           f"{flips[1]} other pairs" if replay_routing
                           else ""))
        check(bool(torch.isfinite(kern).all()), "decode logits not finite")
        check(same, "teacher-forced kernel run does not reproduce the "
              "greedy tokens of the serve step")
        check(max(rels) <= bound, "w8 decode logits differ from the plain "
              "version's beyond the bound")

        def four_steps():
            st = fresh()
            for inp in fed[:4]:
                serve(qparams, st, inp)

        wall_s, busy_s, n_k = device_busy(four_steps)
        print(f"[{n}] {card}: 4 w8 decode steps: wall {wall_s:.4f} s, "
              f"device busy {busy_s:.4f} s in {n_k} kernels, busy share "
              f"{busy_s / wall_s:.3f}")
        out["k2"][f"{name} w8 decode, {P + G} steps (phase {n})"] = k2
        out["k2_wgmma"][f"{name} w8 decode, {P + G} steps (phase {n})"] = \
            wide
        if k5:
            out["k5"][f"{name} w8 decode, cross attention at T = 1, "
                      f"{P + G} steps (phase {n})"] = k5
        del kern, plain
        return step_ms, busy_s / 4 * 1e3

    def engine(n, name, cfg, params, max_len, enc_out=None):
        """The dense ServeEngine at batch 8 over three waves, its caches
        made for ``max_len`` positions (past the window, the local layers
        take their rings), every wave reading ``enc_out``."""
        waves, P, G = ENGINE_WAVES
        Bd = SERVING_DECODE[0]
        rng = np.random.default_rng(n)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   P).tolist(),
                        max_new_tokens=G) for i in range(waves * Bd)]
        eng = ServeEngine(params, cfg, batch=Bd, max_len=max_len,
                          dtype=cfg.dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs, enc_out=enc_out)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        check(all(r.done and len(r.output) == G
                  and all(0 <= t < cfg.vocab_size for t in r.output)
                  for r in reqs), "ServeEngine left a request unanswered")
        print(f"[{n}] {card}: {name} ServeEngine batch {Bd}, max_len "
              f"{max_len} (window {cfg.window_size}), {waves} waves of {Bd} "
              f"requests x ({P} + {G}) tokens: {s:.3f} s, "
              f"{eng.stats.steps} steps ({s / eng.stats.steps * 1e3:.3f} ms "
              f"a step), {eng.stats.tokens_generated / s:.1f} tokens/s; "
              f"request 0 output {reqs[0].output}")

    def routing(n, cfg, routes, layers):
        """The prefill's routing: dropped share and the summed aux."""
        check(len(routes) == layers, f"{len(routes)} routings recorded, "
              f"not {layers}")
        kept = sum(int(r["keep"].sum()) for r in routes)
        pairs = sum(r["keep"].numel() for r in routes)
        aux = float(sum(r["aux"] for r in routes))
        print(f"[{n}] routing of the prefill ({len(routes)} MoE layers, "
              f"{routes[0]['topi'].shape[0]} tokens, top {cfg.moe.top_k} of "
              f"{cfg.moe.num_experts}, capacity {routes[0]['C']} at factor "
              f"{cfg.moe.capacity_factor}): dropped share "
              f"{1 - kept / pairs:.4f} ({pairs - kept} of {pairs} pairs); "
              f"aux loss {aux:.6f} (summed over layers; 1 a layer for a "
              f"uniform router)")
        check(np.isfinite(aux) and aux > 0, f"aux loss {aux}")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    return SimpleNamespace(draw=draw, with_routes=with_routes,
                           context=context, prefill=prefill,
                           w8_decode=w8_decode, engine=engine,
                           routing=routing, free=free)


def hybrid_serving(card: str, dev):
    """Phases 28-30: gemma2-2b, recurrentgemma-9b and phi3.5-moe (4 of its
    32 layers) at full width through their prefill, w8 decode, dense engine
    and ring-buffer decode. The 4 x 1024 prefills sit below both windows
    (4096, 2048), so their windowed K5 launches mask no key; K5's window is
    held by phase 7 and by the ring wraps' forwards past the window.
    Returns each path's K5 and K2 launches."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import Segment
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.nn import attention as A
    from repro_torch.nn import rglru as R
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS
    from repro_torch.train.train_state import make_prefill_step

    gen = torch.Generator(device=dev).manual_seed(28)
    out = {"k5": {}, "k2": {}, "k2_wgmma": {}}
    steps = serving_steps(card, dev, gen, out)
    draw, prefill, w8_decode, engine, routing, free = (
        steps.draw, steps.prefill, steps.w8_decode, steps.engine,
        steps.routing, steps.free)

    def past_window(n, name, cfg, params, qparams, per_step):
        """The dense and the w8 decode step at full depth and batch 8, 64
        positions past the window: each local layer reads its ring of
        ``window`` slots, each global one ``window + 64`` positions. A
        step's cost does not depend on what the caches hold, so the state
        starts at ``kv_len = window + 64`` over zeroed caches instead of
        after as many real steps. Each timed over 8 steps after 2, K2's
        launches of the w8 run counted, busy shares over 4 steps."""
        Bd, W = SERVING_DECODE[0], cfg.window_size
        kv0 = W + RING_PAST_WINDOW
        serve = QS.make_quant_serve_step(cfg)
        tok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=gen,
                            device=dev)

        def fresh():
            st = T.init_decode_state(cfg, Bd, kv0 + RING_PAST_WINDOW,
                                     cfg.dtype, device=dev)
            st["kv_len"] = kv0
            return st

        slots = {spec.mixer: c["k"].shape[2] for seg, cs in
                 zip(cfg.segments, fresh()["caches"])
                 for spec, c in zip(seg.pattern, cs) if "k" in c}
        check(slots.get("local") == W, f"the local layers' caches hold "
              f"{slots.get('local')} slots, not a ring of {W}")
        steps = {"dense": lambda st: T.decode_step(params, st, tok, cfg),
                 "w8": lambda st: serve(qparams, st, tok)}
        for label, step in steps.items():
            st = fresh()
            reset_launches()
            for _ in range(2):
                res, st = step(st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PAST_WINDOW_STEPS):
                res, st = step(st)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PAST_WINDOW_STEPS * 1e3
            k2 = LAUNCHES["quant_matmul"]
            check(st["kv_len"] == kv0 + 2 + PAST_WINDOW_STEPS
                  and bool(torch.isfinite(res.float()).all()),
                  f"{label} decode past the window")

            def four_steps():
                s4 = fresh()
                for _ in range(4):
                    _, s4 = step(s4)

            wall_s, busy_s, _ = device_busy(four_steps)
            print(f"[{n}] {card}: {name} {label} decode step past the "
                  f"window, full depth, batch {Bd}, kv_len {kv0}-"
                  f"{kv0 + 1 + PAST_WINDOW_STEPS} (rings of {W} slots, "
                  f"{slots}): {ms:.3f} ms a step, {Bd / ms * 1e3:.1f} "
                  f"tokens/s, busy share {busy_s / wall_s:.3f}; "
                  f"quant_matmul {k2}")
            if label == "w8":
                check(k2 == per_step * (2 + PAST_WINDOW_STEPS),
                      f"quant_matmul launched {k2} times past the window")
                out["k2"][f"{name} w8 decode past the window, "
                          f"{2 + PAST_WINDOW_STEPS} steps (phase {n})"] = k2
            else:
                check(k2 == 0, "the dense decode launched quant_matmul")

    def ring_wrap(n, name, cfg, checks, bounds):
        """One repeat of the pattern at full width decodes window + 64
        tokens one at a time at batch 2 through the ring buffer; at each
        step of ``checks`` (past the window) the logits are held against
        the last-position logits of a cache-free forward over the same
        tokens (K5 with its window, over more positions than it). After
        the last step each ring slot's k and v are held against the
        forward's at the position the slot must hold."""
        one = dataclasses.replace(
            cfg, segments=(Segment(cfg.segments[0].pattern, 1),))
        params = T.init(gen, one, device=dev)
        W, B = one.window_size, 2
        steps = W + RING_PAST_WINDOW
        tok = torch.randint(0, one.vocab_size, (B, steps), generator=gen,
                            device=dev)
        state = T.init_decode_state(one, B, steps, one.dtype, device=dev)
        ring = [c for spec, c in zip(one.segments[0].pattern,
                                     state["caches"][0])
                if spec.mixer == "local"]
        check(len(ring) == 1 and ring[0]["k"].shape[2] == W,
              "the local layer's cache is not a ring of window slots")
        got = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            logits, state = T.decode_step(params, state, tok[:, t:t + 1], one)
            if t in checks:
                got[t] = logits[:, 0].clone()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        step = make_prefill_step(one)
        rels, seen = {}, []
        kernel = A.flash_attention

        def capturing(q, k, v, **kw):
            if kw.get("window", 0):
                seen.append((k, v))
            return kernel(q, k, v, **kw)

        for t in checks:
            A.flash_attention = capturing if t == steps - 1 else kernel
            try:
                rels[t] = _rel(got[t], step(params,
                                            {"tokens": tok[:, :t + 1]}))
            finally:
                A.flash_attention = kernel
        check(len(seen) == 1 and seen[0][0].shape[1] == steps,
              f"{len(seen)} windowed K5 launches in the forward over "
              f"{steps} tokens, not 1")
        # slot p mod W holds position p, for the last W positions
        pos = torch.arange(steps - W, steps, device=dev)
        slot_rel = {}
        for which, fwd in zip("kv", seen[0]):
            diff = ring[0][which][0][:, pos % W].float() - fwd[:, pos].float()
            slot_rel[which] = float(
                (torch.linalg.vector_norm(diff, dim=(0, 2, 3))
                 / torch.linalg.vector_norm(fwd[:, pos].float(),
                                            dim=(0, 2, 3))).max())
        bound = bounds["ring"]
        print(f"[{n}] {card}: {name} ring wrap, one repeat "
              f"{[s.mixer for s in one.segments[0].pattern]}, {steps} "
              f"tokens at batch {B} through a ring of {W} slots: "
              f"{s:.3f} s ({s / steps * 1e3:.3f} ms a step); decode vs the "
              f"windowed forward, relative L2 at positions "
              + ", ".join(f"{t}: {r:.3e}" for t, r in rels.items())
              + f" (bound {bound:.3e}); every slot's k, v against the "
              f"forward's at its position: largest relative L2 "
              f"{slot_rel['k']:.3e}, {slot_rel['v']:.3e} (bound "
              f"{bounds['slot']:.3e})")
        check(max(rels.values()) <= bound, f"{name} ring decode differs "
              f"from the windowed forward beyond the bound")
        check(max(slot_rel.values()) <= bounds["slot"], f"{name} ring "
              f"slots differ from the forward's k, v beyond the bound")
        del params, state, seen

    # -- 28. gemma2-2b ----------------------------------------------------
    with Phase(28, "gemma2-2b prefill, w8 decode, engine, ring wrap"):
        cfg = ARCHS["gemma2-2b"]
        bounds = SERVING_BOUNDS["gemma2-2b"]
        params = draw(28, "gemma2-2b", cfg)
        prefill(28, "gemma2-2b", cfg, params,
                windowed=n_mixers(cfg, "local"), bound=bounds["prefill"])
        per_step = 7 * cfg.num_layers
        qparams = QS.quantize_params(params, bits=8)
        w8_decode(28, "gemma2-2b", cfg, qparams, per_step, bounds["w8"])
        past_window(28, "gemma2-2b", cfg, params, qparams, per_step)
        del qparams
        free()
        W = cfg.window_size
        engine(28, "gemma2-2b", cfg, params, W + RING_PAST_WINDOW)
        del params
        free()
        ring_wrap(28, "gemma2-2b", cfg, (W, W + 31, W + 63), bounds)
        free()

    # -- 29. recurrentgemma-9b -----------------------------------------------
    with Phase(29, "recurrentgemma-9b prefill, w8 decode, engine, ring wrap"):
        cfg = ARCHS["recurrentgemma-9b"]
        bounds = SERVING_BOUNDS["recurrentgemma-9b"]
        params = draw(29, "recurrentgemma-9b", cfg)
        n_rec = n_mixers(cfg, "rec")
        scan = R._rglru_scan
        scan_s = []

        def timed_scan(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = scan(*a)
            torch.cuda.synchronize()
            scan_s.append(time.perf_counter() - t0)
            return res

        batch, _, prefill_s = prefill(29, "recurrentgemma-9b", cfg, params,
                                      windowed=n_mixers(cfg, "local"),
                                      bound=bounds["prefill"])
        R._rglru_scan = timed_scan
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make_prefill_step(cfg)(params, batch)
            torch.cuda.synchronize()
            timed_s = time.perf_counter() - t0
        finally:
            R._rglru_scan = scan
        check(len(scan_s) == n_rec, f"{len(scan_s)} RG-LRU scans, not "
              f"{n_rec}")
        print(f"[29] {card}: RG-LRU scan (plain PyTorch, a loop over "
              f"{SERVING_PREFILL[1]} steps) in the prefill: {sum(scan_s):.4f} "
              f"s over {n_rec} layers ({sum(scan_s) / n_rec * 1e3:.3f} ms a "
              f"layer), share {sum(scan_s) / timed_s:.3f} of the same "
              f"prefill timed with a synchronize around each scan "
              f"({timed_s:.4f} s; {prefill_s:.4f} s without)")
        per_step = 6 * n_rec + 7 * (cfg.num_layers - n_rec)
        qparams = QS.quantize_params(params, bits=8)
        w8_decode(29, "recurrentgemma-9b", cfg, qparams, per_step,
                  bounds["w8"])
        past_window(29, "recurrentgemma-9b", cfg, params, qparams, per_step)
        del qparams
        free()
        W = cfg.window_size
        engine(29, "recurrentgemma-9b", cfg, params, W + RING_PAST_WINDOW)
        del params
        free()
        ring_wrap(29, "recurrentgemma-9b", cfg, (W, W + 31, W + 63), bounds)
        free()

    # -- 30. phi3.5-moe, 4 of its 32 layers ------------------------------------
    with Phase(30, "phi3.5-moe prefill, routing, engine"):
        full = ARCHS["phi3.5-moe-42b-a6.6b"]
        cfg = dataclasses.replace(
            full, segments=(Segment(full.segments[0].pattern, PHI_LAYERS),))
        params = draw(30, f"phi3.5-moe-42b-a6.6b ({PHI_LAYERS} of "
                      f"{full.num_layers} layers)", cfg)
        _, routes, _ = prefill(30, "phi3.5-moe", cfg, params, windowed=0,
                               bound=SERVING_BOUNDS["phi3.5-moe"]["prefill"],
                               replay_routing=True)
        routing(30, cfg, routes, PHI_LAYERS)
        engine(30, "phi3.5-moe", cfg, params, 64)
        del params
        free()
    return out


def mla_cross_serving(card: str, dev):
    """Phases 31-33: deepseek-v2 (MLA, its dense layer and 3 MoE layers),
    whisper-base (its encoder over 1500 frames and its cross decoder) and
    llama-3.2-vision (cross layers over 1601 patches) at full width through
    their prefill, dense decode, w8 decode and dense engine, every
    ``cross_gate`` at 0.5. Returns each path's K5 and K2 launches, K5's
    times at MLA's shape and the vision step's cross projections."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import Segment
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAO
    from repro_torch.nn import attention as A
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T
    from repro_torch.serve import quantized as QS
    from repro_torch.train.train_state import make_prefill_step

    gen = torch.Generator(device=dev).manual_seed(31)
    out = {"k5": {}, "k2": {}, "k2_wgmma": {}, "k2_cross": {}}
    steps = serving_steps(card, dev, gen, out)
    draw, context, prefill, w8_decode, engine, routing, free = (
        steps.draw, steps.context, steps.prefill, steps.w8_decode,
        steps.engine, steps.routing, steps.free)

    def mla_attention(n, cfg):
        """K5 at MLA's prefill shape (q and k at head_dim 192, v at 128,
        128/128 heads, 4 x 1024, causal) through `attention.attend` (v
        padded to 192, one launch, the output sliced), the kernel alone on
        the padded v, SDPA on v at 128 (a yardstick), and the plain
        version; held against the plain version; device times from CUDA
        graphs; the bound of the unpadded function."""
        m = cfg.mla
        B, Tn = SERVING_PREFILL
        H, hd, vd = cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim, \
            m.v_head_dim
        q, k = (torch.randn((B, Tn, H, hd), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn((B, Tn, H, vd), generator=gen, device=dev).to(
            torch.bfloat16)
        v_pad = torch.nn.functional.pad(v, (0, hd - vd))
        reset_launches()
        got = A.attend(q, k, v, causal=True)
        torch.cuda.synchronize()
        check((LAUNCHES["flash_attention"], LAUNCHES["flash_attention_wgmma"])
              == (1, 1), "MLA's attend did not make one wgmma K5 launch")
        ref = FA.flash_attention_plain(q, k, v)
        tol = FA.flash_attention_bound(q, k, v, ref)
        err = (got.float() - ref.float()).abs()
        check(got.shape == ref.shape and bool((err <= tol).all()),
              "K5 on MLA's padded v differs from the plain version beyond "
              "the bound")
        res = {"shape": f"B {B}, T {Tn}, {H}/{H} heads, q/k head_dim {hd}, "
                        f"v head_dim {vd}, causal, bf16",
               "max_abs_err": float(err.max()),
               "worst_share_of_bound": float((err / tol).max())}
        res["ms"] = _graph_ms(lambda: A.attend(q, k, v, causal=True), [()],
                              reps=10)
        res["kernel_ms_padded_v"] = _graph_ms(
            lambda: FA.flash_attention(q, k, v_pad, causal=True), [()],
            reps=10)
        res["plain_ms"] = event_ms(lambda: FA.flash_attention_plain(q, k, v),
                                   reps=2, warmup=1)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        try:
            res["library_ms"] = _graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), [()], reps=10)
        except RuntimeError as e:       # a yardstick only
            res["library_ms"] = None
            res["library_note"] = f"SDPA refused v at {vd}: {e}"[:300]
        flops = 2 * (hd + vd) * B * H * FAO.visible_pairs(Tn, Tn)
        nbytes = 2 * (2 * B * Tn * H * hd + 2 * B * Tn * H * vd)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
        res["bound_ms"] = max(bytes_ms, ops_ms)
        res["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"[{n}] {card}: K5 at MLA's shape ({res['shape']}): attend "
              f"(v padded, one launch) {res['ms']:.4f} ms, the kernel alone "
              f"{res['kernel_ms_padded_v']:.4f}, SDPA on v at {vd} "
              f"{res['library_ms']}, plain {res['plain_ms']:.4f}, bound "
              f"{res['bound_ms']:.5f} ms ({res['bound_by']}); max abs err "
              f"{res['max_abs_err']:.3e}, {res['worst_share_of_bound']:.3f} "
              f"of the bound" + (f"; {res['library_note']}"
                                 if res["library_ms"] is None else ""))
        out["k5_mla"] = res
        del q, k, v, v_pad, got, ref, tol, err

    def mla_decode_vs_prefill(n, cfg, params, bound):
        """MLA's absorbed decode over the compressed bf16 cache, 16 tokens
        one at a time at batch 2, against the last position of a cache-free
        prefill over the same tokens (K5 with v padded), on the dense layer
        0 alone: in the MoE layers a bf16 rounding that differs between the
        two paths can flip an expert choice, which moves a token by a whole
        expert."""
        one = dataclasses.replace(cfg, segments=cfg.segments[:1])
        p1 = dict(params, segments=params["segments"][:1])
        B, S = 2, 16
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
        state = T.init_decode_state(one, B, S, one.dtype, device=dev)
        check(set(state["caches"][0][0]) == {"c_kv", "k_rope"},
              "deepseek-v2's cache is not the compressed one")
        rels = []
        step = make_prefill_step(one)
        for t in range(S):
            logits, state = T.decode_step(p1, state, tok[:, t:t + 1], one)
            if t in (0, S // 2, S - 1):
                rels.append(_rel(logits[:, 0],
                                 step(p1, {"tokens": tok[:, :t + 1]})))
        print(f"[{n}] {card}: MLA absorbed decode vs the prefill's last "
              f"position, layer 0 (MLA, dense FFN) at full width, batch "
              f"{B}, positions 0, {S // 2}, {S - 1}: "
              f"relative L2 " + ", ".join(f"{r:.3e}" for r in rels)
              + f" (bound {bound:.3e})")
        check(max(rels) <= bound, "MLA's decode differs from the prefill "
              "beyond the bound")

    def cross_decode(n, name, cfg, params, enc_out, bound):
        """The dense decode over ``enc_out`` at batch 8, 32 seeded tokens
        teacher-forced through `decode_step`: every K5 launch (the cross
        attention at T = 1) held element by element against K5's plain
        version on its own inputs; then the same steps with
        `attention.flash_attention` set to the plain version, their logits
        held against the kernel run's step by step."""
        Bd, P, G = SERVING_DECODE
        tok = torch.randint(0, cfg.vocab_size, (Bd, P + G), generator=gen,
                            device=dev)
        kernel = A.flash_attention
        shares = []

        def held(q, k, v, **kw):
            o = kernel(q, k, v, **kw)
            ref = FA.flash_attention_plain(q, k, v, **kw)
            shares.append(_within(o, ref, FA.flash_attention_bound(
                q, k, v, ref, **kw))[1])
            return o

        def teacher_forced():
            st = T.init_decode_state(cfg, Bd, P + G, cfg.dtype, device=dev)
            st["enc_out"] = enc_out
            lg = []
            for t in range(P + G):
                x, st = T.decode_step(params, st, tok[:, t:t + 1], cfg)
                lg.append(x[:, 0])
            return torch.stack(lg)

        A.flash_attention = held
        try:
            reset_launches()
            kern = teacher_forced()
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        finally:
            A.flash_attention = kernel
        A.flash_attention = FA.flash_attention_plain
        try:
            plain = teacher_forced()
        finally:
            A.flash_attention = kernel
        k5 = n_mixers(cfg, "cross") * (P + G)
        rels = [_rel(kern[i], plain[i]) for i in range(P + G)]
        print(f"[{n}] {name} dense decode over {tuple(enc_out.shape)}, "
              f"batch {Bd}, {P + G} teacher-forced steps: K5 "
              f"{launches['flash_attention']} launches "
              f"({launches['flash_attention_wgmma']} wgmma, T = 1, "
              f"non-causal); each against K5's plain version on its inputs: "
              f"largest share of the bound {max(shares):.3e}; logits against "
              f"the same steps on the plain version: largest relative L2 of "
              f"a step {max(rels):.3e} (bound {bound:.3e})")
        check(launches["flash_attention"] == k5 == len(shares)
              == launches["flash_attention_wgmma"],
              f"the dense decode made {launches['flash_attention']} K5 "
              f"launches, not {k5} through the wgmma body")
        check(bool(torch.isfinite(kern).all()), "decode logits not finite")
        check(max(shares) <= 1.0, f"a cross-attention K5 launch of {name}'s "
              f"decode differs from the plain version beyond the bound")
        check(max(rels) <= bound, f"{name}'s dense decode logits differ "
              f"from the plain version's beyond the bound")
        out["k5"][f"{name} dense decode, cross attention at T = 1, "
                  f"{P + G} steps (phase {n})"] = k5
        del kern, plain

    def cross_projection(n, name, cfg, qparams, context, step):
        """The w8 step's cross K and V projections, which the decode makes
        again at every step (as the JAX package does): one cross layer's
        two K2 products at M = batch x context length, both through the
        large-M body, device time from a CUDA graph, cuBLAS on the
        dequantized weights beside it, and the share of the w8 step (wall
        and device ms a step) the step's launches of them take."""
        segment = cfg.segments[0]
        at = next(i for i, spec in enumerate(segment.pattern)
                  if spec.mixer == "cross")
        p = T._take(qparams["segments"][0][at]["mixer"], 0)
        x = context.to(L.torch_dtype(cfg.dtype))
        dt = cfg.dtype

        def k2():
            L.dense_apply(p["c_wk"], x, dtype=dt)
            L.dense_apply(p["c_wv"], x, dtype=dt)

        reset_launches()
        k2()
        torch.cuda.synchronize()
        check(LAUNCHES["quant_matmul"] == LAUNCHES["quant_matmul_wgmma"] == 2,
              f"{name}'s cross K and V projections did not both take the "
              f"large-M body: {dict(LAUNCHES)}")
        w = [L.dequantize(p[c]["kernel"], torch.bfloat16).reshape(
            cfg.d_model, -1) for c in ("c_wk", "c_wv")]
        xf = x.reshape(-1, cfg.d_model)

        def cublas():
            torch.matmul(xf, w[0])
            torch.matmul(xf, w[1])

        ms, lib_ms = _graph_ms(k2, [()], reps=10), _graph_ms(cublas, [()],
                                                             reps=10)
        n_cross = n_mixers(cfg, "cross")
        M, K, N = xf.shape[0], cfg.d_model, w[0].shape[1]
        bound = 2 * qmm_bound_ms(M, K, N, 2)[0]
        res = {"shape": f"M {M}, K {K}, N {N}, bf16 x, two products a "
                        f"cross layer, {n_cross} cross layers",
               "body": "wgmma (large-M)",
               "ms_a_layer": ms, "library_ms_a_layer": lib_ms,
               "bound_ms_a_layer": bound,
               "share_of_wall_step": n_cross * ms / step[0],
               "share_of_device_step": n_cross * ms / step[1]}
        print(f"[{n}] {card}: the cross K and V projections of {name}'s w8 "
              f"step ({res['shape']}): K2's large-M body {ms:.4f} ms a layer "
              f"on the device, cuBLAS on the dequantized weights "
              f"{lib_ms:.4f}, bound {bound:.5f} ({ms / bound:.2f}x); "
              f"{n_cross} layers take {n_cross * ms:.3f} ms, "
              f"{res['share_of_wall_step']:.3f} of the w8 step's "
              f"{step[0]:.3f} ms wall and {res['share_of_device_step']:.3f} "
              f"of its {step[1]:.3f} ms device time")
        out["k2_cross"][name] = res

    # -- 31. deepseek-v2: MLA, its dense layer and 3 of its MoE layers ------
    with Phase(31, "deepseek-v2 prefill, MLA decode, engine, w8 decode"):
        full = ARCHS["deepseek-v2-236b"]
        dense_seg, moe_seg = full.segments
        cfg = dataclasses.replace(full, segments=(
            dense_seg, Segment(moe_seg.pattern, DEEPSEEK_MOE_LAYERS)))
        bounds = SERVING_BOUNDS["deepseek-v2"]
        params = draw(31, f"deepseek-v2-236b (its dense layer and "
                      f"{DEEPSEEK_MOE_LAYERS} of its "
                      f"{moe_seg.repeats} MoE layers)", cfg)
        _, routes, _ = prefill(31, "deepseek-v2", cfg, params,
                               windowed=0, bound=bounds["prefill"],
                               replay_routing=True)
        routing(31, cfg, routes, DEEPSEEK_MOE_LAYERS)
        del routes
        mla_attention(31, cfg)
        mla_decode_vs_prefill(31, cfg, params, bounds["decode"])
        engine(31, "deepseek-v2", cfg, params, 64)
        qparams = QS.quantize_params(params, bits=8)
        del params      # the w8 step dequantizes the expert stacks
        free()
        # a layer: w_dq, w_uq, w_dkv, w_kr and wo; the dense FFN's or
        # the shared experts' 3; the LM head
        w8_decode(31, "deepseek-v2", cfg, qparams,
                  8 * cfg.num_layers + 1, bounds["w8"],
                  replay_routing=True)
        del qparams
        free()

    # -- 32. whisper-base: the encoder and the cross decoder ------------------
    with Phase(32, "whisper-base encoder, prefill, decode, engine, w8 decode"):
        cfg = ARCHS["whisper-base"]
        bounds = SERVING_BOUNDS["whisper-base"]
        params = draw(32, "whisper-base", cfg)
        n_enc = cfg.encoder.num_layers
        _, frames = context(cfg, SERVING_PREFILL[0])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        enc = T._encoder_forward(params["encoder"], frames, cfg,
                                 remat=False)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        kernel = A.flash_attention
        A.flash_attention = FA.flash_attention_plain
        try:
            enc_plain = T._encoder_forward(params["encoder"], frames, cfg,
                                           remat=False)
        finally:
            A.flash_attention = kernel
        rel = _rel(enc, enc_plain)
        print(f"[32] {card}: whisper-base encoder over "
              f"{tuple(frames.shape)} frames: {enc_s:.4f} s (first "
              f"call), K5 {launches['flash_attention']} launches "
              f"({launches['flash_attention_wgmma']} wgmma, non-causal, "
              f"T = S = {frames.shape[1]}); against K5's plain version "
              f"relative L2 {rel:.3e} (bound {bounds['prefill']:.3e})")
        check(launches["flash_attention"] == n_enc
              == launches["flash_attention_wgmma"],
              f"the encoder made {launches['flash_attention']} K5 "
              f"launches, not {n_enc} through the wgmma body")
        check(tuple(enc.shape) == tuple(frames.shape)
              and bool(torch.isfinite(enc).all())
              and rel <= bounds["prefill"], "the encoder's output")
        out["k5"]["whisper-base encoder (phase 32)"] = n_enc
        del enc, enc_plain
        prefill(32, "whisper-base", cfg, params, windowed=0,
                bound=bounds["prefill"])
        _, frames = context(cfg, SERVING_DECODE[0])
        enc8 = T._encoder_forward(params["encoder"], frames, cfg,
                                  remat=False)
        cross_decode(32, "whisper-base", cfg, params, enc8, bounds["dense"])
        engine(32, "whisper-base", cfg, params, 64, enc_out=enc8)
        qparams = QS.quantize_params(params, bits=8)
        # a layer: 4 self-attention, 4 cross-attention and 2 MLP
        # products; the LM head
        step = w8_decode(32, "whisper-base", cfg, qparams,
                         10 * cfg.num_layers + 1, bounds["w8"], enc_out=enc8)
        cross_projection(32, "whisper-base", cfg, qparams, enc8, step)
        del params, qparams, enc8
        free()

    # -- 33. llama-3.2-vision: cross layers over 1601 patches ---------------
    with Phase(33, "llama-3.2-vision prefill, decode, engine, w8 decode"):
        cfg = ARCHS["llama-3.2-vision-11b"]
        bounds = SERVING_BOUNDS["llama-3.2-vision"]
        params = draw(33, "llama-3.2-vision-11b", cfg)
        prefill(33, "llama-3.2-vision", cfg, params, windowed=0,
                bound=bounds["prefill"])
        _, patches = context(cfg, SERVING_DECODE[0])
        cross_decode(33, "llama-3.2-vision", cfg, params, patches,
                     bounds["dense"])
        engine(33, "llama-3.2-vision", cfg, params, 64, enc_out=patches)
        qparams = QS.quantize_params(params, bits=8)
        del params
        free()
        # a layer: 7 products; a cross layer 4 more; the LM head
        step = w8_decode(33, "llama-3.2-vision", cfg, qparams,
                         7 * cfg.num_layers + 4 * n_mixers(cfg, "cross")
                         + 1, bounds["w8"], enc_out=patches)
        cross_projection(33, "llama-3.2-vision", cfg, qparams, patches, step)
        del qparams, patches
        free()
    return out


# phase 34: the later families trained at full width. name: (arch, the
# repeats kept of each segment (None: all; segments past the tuple are
# dropped), B, T, the parameters at that depth as the JAX package's
# `param_count` counts them). The cuts keep every block kind:
# recurrentgemma-9b 2 of its 12 (rec, rec, local) periods and not its
# (rec, rec) tail; phi3.5-moe 2 of its 32 layers; deepseek-v2 its dense
# layer and 1 of its 59 MoE layers (160 experts, top 6, 2 shared);
# llama-3.2-vision 2 of its 8 periods (4 self-attention layers and a cross
# layer each); gemma2-2b and whisper-base whole. gemma2-2b at T 8192 and
# recurrentgemma-9b at 4096 train past their windows (4096, 2048).
FAMILY_TRAIN = {
    "gemma2-2b": ("gemma2-2b", None, 1, 8192, 2614341888),
    "recurrentgemma-9b": ("recurrentgemma-9b", (2,), 1, 4096, 2361577472),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", (2,), 4, 1024, 2863288320),
    "deepseek-v2": ("deepseek-v2-236b", (1, 1), 1, 1024, 5358679040),
    "whisper-base": ("whisper-base", None, 4, 1024, 114727942),
    "llama-3.2-vision": ("llama-3.2-vision-11b", (2,), 4, 1024, 3315691522),
}
FAMILY_STEPS = 3
# phase 34's bounds on the gradient through the kernels against the one
# through K5's plain version: the relative difference of the global norm,
# the largest relative difference of a leaf's norm, and the largest
# relative L2 of a leaf's difference, each about 4x the H100's reading
# (the gradients repeat to the bit from run to run); a K5 backward that
# gets a direction wrong moves a leaf's relative L2 to order 1
TRAIN_BOUNDS = {
    "gemma2-2b": (5.3e-4, 1.2e-3, 0.053),
    "recurrentgemma-9b": (1.2e-5, 2.7e-4, 0.022),
    "phi3.5-moe": (6.5e-6, 3.5e-4, 0.035),
    "deepseek-v2": (2.5e-6, 1.5e-3, 0.044),
    "whisper-base": (1.8e-4, 0.019, 0.056),
    "llama-3.2-vision": (2.8e-4, 0.027, 0.088),
}


def cut_depth(cfg, repeats):
    """``cfg`` with the first ``len(repeats)`` segments at those repeats
    and the rest dropped (``repeats`` None: ``cfg`` whole)."""
    import dataclasses

    from repro_torch.configs.base import Segment
    if repeats is None:
        return cfg
    return dataclasses.replace(cfg, segments=tuple(
        Segment(s.pattern, r) for s, r in zip(cfg.segments, repeats)))


def live_cuda_tensors(top: int = 4):
    """(bytes, the largest few) of the CUDA storages that the Python
    objects the garbage collector tracks still reach, each storage once;
    an entry: (bytes, shape, dtype, the types of the objects that refer
    to the tensor and of those that refer to them)."""
    import torch
    seen, total, found = set(), 0, []
    for o in gc.get_objects():
        if not isinstance(o, torch.Tensor) or not o.is_cuda:
            continue
        st = o.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += st.nbytes()
        found.append((st.nbytes(), o))
    found.sort(key=lambda t: -t[0])
    out = []
    for n, t in found[:top]:
        refs = [r for r in gc.get_referrers(t) if r is not found][:3]
        chain = sorted({type(r).__name__ for r in refs}
                       | {type(rr).__name__ for r in refs
                          for rr in gc.get_referrers(r)
                          if rr is not refs and rr is not found})
        out.append((n, tuple(t.shape), str(t.dtype), chain[:8]))
    del found
    return total, out


def family_training(card: str, dev):
    """Phase 34: gemma2-2b, recurrentgemma-9b, phi3.5-moe, deepseek-v2,
    whisper-base and llama-3.2-vision trained at full width with the depths
    of ``FAMILY_TRAIN``: one gradient through the kernels against one
    through K5's plain version, 3 donated steps, their times, peak memory
    and busy share; K5's backward at each family's attention shapes
    against its bound and SDPA's backward; whisper-base through
    ``launch.train`` preempted and resumed. Returns K5's forward and
    backward launches by path and K5's backward times by shape."""
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAO
    from repro_torch.kernels.flash_attention.ops import bwd_cost
    from repro_torch.launch import train as LT
    from repro_torch.nn import attention as A
    from repro_torch.nn import layers as L
    from repro_torch.nn import moe as M
    from repro_torch.nn import rglru as R
    from repro_torch.nn import transformer as T
    from repro_torch.train import losses
    from repro_torch.train import train_state as TS
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_leaves, tree_unflatten)

    gen = torch.Generator(device=dev).manual_seed(34)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"k5": {}, "k5_bwd": {}, "k5_bwd_wgmma": {}, "k5_bwd_ms": {},
           "train": {}, "grad_check": {}}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # what phases 1-33 leave allocated: the tensors Python still reaches,
    # then the rest (cuBLAS keeps a workspace for each stream it ran on,
    # allocated through PyTorch's allocator)
    free()
    held = torch.cuda.memory_allocated()
    reached, largest = live_cuda_tensors()
    handler = signal.getsignal(signal.SIGTERM)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    free()
    print(f"[34] at the phase's start: {held / 2**30:.3f} GiB allocated, "
          f"{reached / 2**30:.3f} GiB of it in tensors Python reaches "
          f"(largest: " + "; ".join(
              f"{n / 2**30:.3f} GiB {shape} {dt} held by {chain}"
              for n, shape, dt, chain in largest)
          + f"); SIGTERM's handler {getattr(handler, '__qualname__', handler)}"
          f"; after releasing cuBLAS's workspaces "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    def with_routes(fn, routes=None):
        """``fn()`` with the MoE layers' expert choices recorded in call
        order (forward, then again under remat), or replayed from
        ``routes``: a replayed call keeps the recorded experts and weighs
        them, and makes the aux loss, from its own router probabilities,
        so the router's gradient is its own. Returns (result, choices
        recorded, choices the replayed calls would have flipped)."""
        route = M._route
        seen, flips = [], [0]
        replay = None if routes is None else iter(routes)

        def routed(logits, m):
            topw, topi, aux = route(logits, m)
            if replay is None:
                seen.append(topi.detach().clone())
                return topw, topi, aux
            theirs = next(replay)
            flips[0] += int((topi != theirs).sum())
            probs = torch.softmax(logits, dim=-1) if m.router_softmax \
                else torch.sigmoid(logits)
            topw = probs.gather(-1, theirs)
            topw = topw / torch.clamp_min(topw.sum(dim=-1, keepdim=True),
                                          1e-9)
            E = logits.shape[-1]
            ce = torch.nn.functional.one_hot(theirs[:, 0], E).float().mean(
                dim=0)
            return topw, theirs, E * torch.sum(probs.mean(dim=0) * ce)

        M._route = routed
        try:
            return fn(), seen, flips[0]
        finally:
            M._route = route

    def batch_for(cfg, tokens):
        b = {"tokens": tokens}
        B = tokens.shape[0]
        if cfg.encoder is not None:
            b["frames"] = torch.randn(
                (B, cfg.encoder.num_frames, cfg.d_model), generator=gen,
                device=dev).to(L.torch_dtype(cfg.dtype))
        if cfg.vision is not None:
            b["patches"] = torch.randn(
                (B, cfg.vision.num_patches, cfg.d_model), generator=gen,
                device=dev).to(L.torch_dtype(cfg.dtype))
        return b

    def timed_scan(scan, spans):
        """`rglru._rglru_scan` with its seconds appended to ``spans``: the
        forward (again under remat) with a synchronize around it, and the
        backward from y's gradient to the gates' (hooks on the tensors of
        the forward that autograd differentiates)."""
        def timed(x, r_gate, i_gate, lam, c, h0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, h = scan(x, r_gate, i_gate, lam, c, h0)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t0)
            if y.requires_grad:
                mark = []

                def start(g):
                    torch.cuda.synchronize()
                    mark.append(time.perf_counter())

                def end(g):
                    torch.cuda.synchronize()
                    if len(mark) == 1:
                        mark.append(time.perf_counter())
                        spans.append(mark[1] - mark[0])

                y.register_hook(start)
                r_gate.register_hook(end)
            return y, h
        return timed

    def gradient(cfg, params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        logits, aux = T.forward(tree_unflatten(params, leaves), batch, cfg,
                                remat=True)
        loss = losses.next_token_loss(logits, batch["tokens"], aux=aux)
        del logits
        grads = list(torch.autograd.grad(loss, leaves))
        return float(loss.detach()), grads

    def k5_counts(cfg):
        """(K5 launches a forward, of them non-causal): each self-attention
        (a cross block's too) causal, each cross attention and encoder
        layer not."""
        n_free = n_mixers(cfg, "cross") + (cfg.encoder.num_layers
                                           if cfg.encoder else 0)
        n_causal = sum(n_mixers(cfg, m) for m in ("attn", "local", "cross"))
        return n_causal + n_free, n_free

    def hd_takes_wgmma_bwd(cfg):
        """Whether K5's backward takes its wgmma body on this model's bf16
        attention: q and k's head_dim (MLA's at nope + rope, 192) one of
        the body's 64, 128, 192 and 256."""
        m = cfg.mla
        hd = m.qk_nope_head_dim + m.qk_rope_head_dim if m else \
            cfg.resolved_head_dim
        return hd in FAO.WGMMA_BWD_HEAD_DIMS

    def gradient_check(name, cfg, params, batch):
        """One gradient through the kernels (launches counted, K5's calls
        recorded causal or not) against one with `attention.flash_attention`
        set to K5's plain version, the MoE routing replayed; MoE families
        also take a second kernel gradient, compared to the bit. Leaves are
        compared and freed one at a time, within ``TRAIN_BOUNDS``."""
        causal = []
        kernel = A.flash_attention

        def recording(q, k, v, **kw):
            causal.append(kw.get("causal", True))
            return kernel(q, k, v, **kw)

        A.flash_attention = recording
        scan, spans = R._rglru_scan, []
        if cfg.rglru is not None:
            R._rglru_scan = timed_scan(scan, spans)
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss_k, g_k), routes, _ = with_routes(
                lambda: gradient(cfg, params, batch))
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
        finally:
            A.flash_attention = kernel
            R._rglru_scan = scan
        scan_note = ""
        if cfg.rglru is not None:
            n_rec = n_mixers(cfg, "rec")
            check(len(spans) == 3 * n_rec, f"{len(spans)} timed RG-LRU "
                  f"spans, not {3 * n_rec} (forward, again under remat, "
                  f"backward)")
            out["rglru_scan"] = dict(s=sum(spans), of_s=grad_s,
                                     share=sum(spans) / grad_s)
            scan_note = (f"; the RG-LRU scan ({n_rec} layers, forward twice "
                         f"and backward, {batch['tokens'].shape[1]} steps "
                         f"each) {sum(spans):.4f} s, share "
                         f"{sum(spans) / grad_s:.3f} of this gradient timed "
                         f"with a synchronize around each ({grad_s:.4f} s)")
        per_fwd, n_free = k5_counts(cfg)
        wgmma_bwd = hd_takes_wgmma_bwd(cfg)
        fwd, bwd = launches["flash_attention"], launches["flash_attention_bwd"]
        check(fwd == 2 * per_fwd == len(causal)
              and sum(not c for c in causal) == 2 * n_free
              and launches["flash_attention_wgmma"] == fwd
              and bwd == per_fwd
              and launches["flash_attention_bwd_wgmma"]
              == (bwd if wgmma_bwd else 0),
              f"{name}'s gradient launched {launches}, {len(causal)} K5 "
              f"calls ({sum(not c for c in causal)} non-causal); expected "
              f"{2 * per_fwd} forward ({2 * n_free} non-causal) and "
              f"{per_fwd} backward, "
              f"{'all' if wgmma_bwd else 'none'} through the wgmma body")
        rerun = ""
        if cfg.moe is not None:
            (_, g_k2), _, flips2 = with_routes(
                lambda: gradient(cfg, params, batch), routes)
            same = [torch.equal(a, b) for a, b in zip(g_k, g_k2)]
            diff2 = max(float((a.float() - b.float()).norm())
                        / max(float(b.float().norm()), 1e-30)
                        for a, b in zip(g_k, g_k2))
            del g_k2
            rerun = (f"; a second kernel gradient: {sum(same)} of "
                     f"{len(same)} leaves equal to the bit, largest relative"
                     f" L2 of a leaf's difference {diff2:.3e}, {flips2} "
                     f"expert choices flipped unreplayed")
            check(diff2 <= 2 ** -8, f"{name}'s gradient moved between two "
                  f"kernel runs by {diff2:.3e}")
        A.flash_attention = FA.flash_attention_plain
        try:
            (loss_p, g_p), _, flips = with_routes(
                lambda: gradient(cfg, params, batch), routes or None)
        finally:
            A.flash_attention = kernel
        del routes
        paths = tree_leaves(T.map_tree(lambda p, _: "/".join(map(str, p)),
                                       params))
        sq_k = sq_p = 0.0
        leaf_rel, diff_rel = [], []
        while g_k:
            a, b = g_k.pop(0).float(), g_p.pop(0).float()
            na, nb = float(a.norm()), float(b.norm())
            sq_k, sq_p = sq_k + na * na, sq_p + nb * nb
            leaf_rel.append(abs(na - nb) / max(nb, 1e-30))
            diff_rel.append(float((a - b).norm()) / max(nb, 1e-30))
            del a, b
        norm_k, norm_p = sq_k ** 0.5, sq_p ** 0.5
        g_bound, leaf_bound, diff_bound = TRAIN_BOUNDS[name]
        g_rel = abs(norm_k - norm_p) / norm_p
        worst = int(np.argmax(leaf_rel))
        print(f"[34] {name}: one gradient, remat on: K5 {fwd} forward "
              f"({2 * n_free} non-causal) and {bwd} backward launches "
              f"({launches['flash_attention_bwd_wgmma']} through the "
              f"backward's wgmma body); loss {loss_k:.6f} (plain K5 "
              f"{loss_p:.6f}); global gradient norm {norm_k:.6f} (plain "
              f"{norm_p:.6f}, relative difference {g_rel:.3e}, bound "
              f"{g_bound:.3e}); largest relative difference of a leaf's norm "
              f"{leaf_rel[worst]:.3e} at {paths[worst]} (bound "
              f"{leaf_bound:.3e}); relative L2 of the leaves' differences: "
              f"median {float(np.median(diff_rel)):.3e}, largest "
              f"{max(diff_rel):.3e} at {paths[int(np.argmax(diff_rel))]} "
              f"(bound {diff_bound:.3e})"
              + (f"; the plain run would flip {flips} expert choices "
                 f"(replayed)" if cfg.moe is not None else "") + rerun
              + scan_note)
        check(np.isfinite(loss_k) and np.isfinite(norm_k),
              f"{name}'s loss or gradient is not finite")
        check(g_rel <= g_bound, f"{name}'s global gradient norm differs "
              f"from the plain version's beyond the bound")
        check(max(leaf_rel) <= leaf_bound, f"a leaf's gradient norm of "
              f"{name} differs from the plain version's beyond the bound")
        check(max(diff_rel) <= diff_bound, f"a leaf's gradient of {name} "
              f"differs from the plain version's beyond the bound")
        out["grad_check"][name] = dict(global_rel=g_rel,
                                       leaf_norm_rel=max(leaf_rel),
                                       leaf_diff_rel=max(diff_rel))
        return fwd, bwd

    def train(name, cfg, params, B, Tn):
        """FAMILY_STEPS donated steps from fresh AdamW moments, then one
        more under the profiler for the busy share."""
        opt = AdamWConfig(lr=3e-4, total_steps=FAMILY_STEPS + 2,
                          warmup_steps=1)
        state = TS.TrainState(params, adamw_init(params))
        step = TS.make_train_step(cfg, opt, remat=True)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=Tn, global_batch=B))
        batches = [batch_for(cfg, torch.as_tensor(
            pipe.batch_at(i)["tokens"], device=dev))
            for i in range(FAMILY_STEPS)]
        losses_, times = [], []
        free()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses_.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = float(np.median(times[1:]))
        free()
        # the busy share of one more step under the profiler, against the
        # steady step's wall time
        wall_s, busy_s, n_k = device_busy(lambda: step(state, batches[0]),
                                          wall_s=steady, cpu=False)
        res = dict(step_s=steady, tokens_per_s=B * Tn / steady,
                   peak_gib=peak, busy_share=busy_s / wall_s,
                   kernels=n_k, losses=losses_)
        if cfg.rglru is not None:
            res["rglru_scan_share"] = out["rglru_scan"]["share"]
        print(f"[34] {card}: {name}, {FAMILY_STEPS} donated steps of B={B} "
              f"T={Tn}: losses " + ", ".join(f"{x:.6f}" for x in losses_)
              + f"; step s {[round(x, 4) for x in times]}; steady "
              f"{steady:.4f} s a step, {B * Tn / steady:.0f} tokens/s; peak "
              f"device memory {peak:.2f} GiB; busy {busy_s:.4f} s of "
              f"{wall_s:.4f} s in {n_k} kernels, share "
              f"{busy_s / wall_s:.3f}; launches {launches}")
        check(all(np.isfinite(x) for x in losses_),
              f"{name}'s losses {losses_}")
        del state, batches
        return res, launches

    def sdpa_bwd_ms(q, k, v, do, causal, window):
        """SDPA's backward alone at these shapes (the forward on a side
        stream, torch.autograd.grad of its output captured in a CUDA graph
        on it), or None where SDPA refuses them."""
        F = torch.nn.functional
        T_, S_ = q.shape[1], k.shape[1]
        mask = None
        if window:
            qi = torch.arange(T_, device=dev)[:, None]
            ki = torch.arange(S_, device=dev)[None, :]
            mask = (ki <= qi) & (ki > qi - window)
        if "sdpa" not in _STREAMS:
            _STREAMS["sdpa"] = torch.cuda.Stream()
        stream = _STREAMS["sdpa"]
        stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(stream):
                ins = tuple(x.detach().transpose(1, 2).requires_grad_(True)
                            for x in (q, k, v))
                o = F.scaled_dot_product_attention(
                    *ins, attn_mask=mask, is_causal=causal and mask is None,
                    enable_gqa=True)
            torch.cuda.current_stream().wait_stream(stream)
            dos = do[..., :o.shape[-1]].transpose(1, 2)
            return _graph_ms(lambda: torch.autograd.grad(
                o, ins, dos, retain_graph=True), [()], reps=5,
                stream=stream)
        except RuntimeError as e:
            print(f"[34] SDPA refused {tuple(q.shape)} {tuple(k.shape)} "
                  f"{tuple(v.shape)}: {str(e)[:200]}")
            return None

    def k5_bwd_time(label, B, Tq, S, H, KV, hd, causal, window, cap,
                    vd=None):
        """K5's backward at one training shape: dq, dk and dv held element
        by element against `flash_attention_bwd_plain` on the same inputs
        with `flash_attention_bwd_tolerance`, as phase 26 holds its cases;
        device ms from a CUDA graph, the body, the bound of `bwd_cost`
        (bytes or bf16 tensor-core operations), SDPA's backward (none with
        a softcap, which SDPA lacks). ``vd``: v's own head_dim where the
        path pads v to hd with zeros (MLA), as SDPA and the bound then take
        it."""
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, do = rnd(B, Tq, H, hd), rnd(B, Tq, H, hd)
        k, v = rnd(B, S, KV, hd), rnd(B, S, KV, hd)
        if vd is not None:
            v[..., vd:] = 0
            do[..., vd:] = 0
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = FA.flash_attention_with_lse(q, k, v, **kw)
        body = "wgmma" if FA.takes_wgmma_bwd(q, k, v, o, do) else "CUDA-core"
        got = FA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        ref = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
        tols = FA.flash_attention_bwd_tolerance(q, k, v, o, do, lse, ref,
                                                **kw)
        errs = []
        for gname, a, b, t in zip(("dq", "dk", "dv"), got, ref, tols):
            err, share, ok = _within(a, b, t)
            errs.append((gname, err, share))
            check(ok and bool(torch.isfinite(a).all()), f"flash_attention_"
                  f"bwd disagrees with its plain version at {label} {gname}"
                  f" (max abs err {err:.3e}, {share:.3f} of the bound)")
        del got, ref, tols
        free()
        ms = _graph_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,
                                                      **kw), [()], reps=5)
        flops, nbytes = bwd_cost(B, Tq, S, H, KV, hd, 2, causal=causal,
                                 window=window, vd=vd)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
        lib = None if cap else sdpa_bwd_ms(
            q, k, v if vd is None else v[..., :vd].contiguous(), do, causal,
            window)
        res = {"shape": f"B {B}, T {Tq}, S {S}, {H}/{KV} heads of {hd}"
                        + (f" (v {vd}, padded)" if vd else "")
                        + f", {'causal' if causal else 'non-causal'}"
                        + (f", window {window}" if window else "")
                        + (f", softcap {cap}" if cap else "") + ", bf16",
               "body": body, "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": lib,
               "split": FA.bwd_head_split(S, B, H, KV, sms)
               if body == "wgmma" and hd > 128 else 1,
               "max_abs_err": max(e for _, e, _ in errs),
               "max_share": max(sh for _, _, sh in errs)}
        print(f"[34] {card}: flash_attention_bwd at {label} ({res['shape']}),"
              f" {body} body: against the plain version, max abs err "
              + ", ".join(f"{g} {e:.3e} ({sh:.3f} of the bound)"
                          for g, e, sh in errs)
              + f"; {ms:.4f} ms device (CUDA graph), bound "
              f"{res['bound_ms']:.5f} ms ({res['bound_by']}), "
              f"{ms / res['bound_ms']:.2f}x; SDPA's backward "
              + (f"{lib:.4f} ms, K5 {ms / lib:.2f}x of it" if lib is not None
                 else "none (softcap)" if cap else "none (refused)")
              + (f"; heads split over {res['split']} blocks"
                 if res["split"] > 1 else ""))
        out["k5_bwd_ms"][label] = res
        del q, k, v, o, do, lse

    with Phase(34, "training the hybrid, MoE, MLA, whisper and vision "
                   "families"):
        for name, (arch, repeats, B, Tn, n_want) in FAMILY_TRAIN.items():
            t_family = time.perf_counter()
            cfg = cut_depth(ARCHS[arch], repeats)
            params = T.init(gen, cfg, device=dev)
            params = T.map_tree(lambda path, t: torch.full_like(t, 0.5)
                                if "cross_gate" in path else t, params)
            n_params = T.param_count(params)
            n_layers = cfg.num_layers + (cfg.encoder.num_layers
                                         if cfg.encoder else 0)
            print(f"[34] {name}: {n_layers} layers kept, d_model "
                  f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
                  f"of {cfg.resolved_head_dim}, window {cfg.window_size}: "
                  f"{n_params} parameters, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated")
            check(n_params == n_want, f"{name} has {n_params} parameters, "
                  f"not {n_want}")
            tokens = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                                   device=dev)
            t0 = time.perf_counter()
            gradient_check(name, cfg, params, batch_for(cfg, tokens))
            check_s = time.perf_counter() - t0
            del tokens
            free()
            t0 = time.perf_counter()
            res, launches = train(name, cfg, params, B, Tn)
            train_s = time.perf_counter() - t0
            del params
            free()
            out["train"][name] = res
            key = f"{name} training, {FAMILY_STEPS} steps (phase 34)"
            out["k5"][key] = launches["flash_attention"]
            out["k5_bwd"][key] = launches["flash_attention_bwd"]
            out["k5_bwd_wgmma"][key] = launches["flash_attention_bwd_wgmma"]
            per_fwd, _ = k5_counts(cfg)
            wgmma_bwd = hd_takes_wgmma_bwd(cfg)
            check(launches["flash_attention"] == 2 * per_fwd * FAMILY_STEPS
                  == launches["flash_attention_wgmma"]
                  and launches["flash_attention_bwd"]
                  == per_fwd * FAMILY_STEPS
                  and launches["flash_attention_bwd_wgmma"]
                  == (launches["flash_attention_bwd"] if wgmma_bwd else 0),
                  f"{name}'s {FAMILY_STEPS} steps launched {launches}")
            # K5's backward at this family's attention shapes
            H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
            cap = cfg.attn_softcap
            if name == "gemma2-2b":
                k5_bwd_time("gemma2-2b global", B, Tn, Tn, H, KV, hd, True,
                            0, cap)
                k5_bwd_time("gemma2-2b local", B, Tn, Tn, H, KV, hd, True,
                            cfg.window_size, cap)
            elif name == "recurrentgemma-9b":
                k5_bwd_time(name, B, Tn, Tn, H, KV, hd, True,
                            cfg.window_size, cap)
            elif name == "deepseek-v2":
                m = cfg.mla
                k5_bwd_time(name, B, Tn, Tn, H, H,
                            m.qk_nope_head_dim + m.qk_rope_head_dim, True,
                            0, 0.0, vd=m.v_head_dim)
            elif name == "whisper-base":
                F_ = cfg.encoder.num_frames
                k5_bwd_time("whisper-base encoder", B, F_, F_, H, KV, hd,
                            False, 0, 0.0)
                k5_bwd_time("whisper-base cross", B, Tn, F_, H, KV, hd,
                            False, 0, 0.0)
                k5_bwd_time("whisper-base decoder", B, Tn, Tn, H, KV, hd,
                            True, 0, 0.0)
            elif name == "llama-3.2-vision":
                k5_bwd_time("llama-3.2-vision cross", B, Tn,
                            cfg.vision.num_patches, H, KV, hd, False, 0, 0.0)
                k5_bwd_time("llama-3.2-vision self", B, Tn, Tn, H, KV, hd,
                            True, 0, 0.0)
            else:
                k5_bwd_time(name, B, Tn, Tn, H, KV, hd, True, 0, cap)
            free()
            print(f"[34] {name}: {time.perf_counter() - t_family:.3f} s for "
                  f"the family, {check_s:.3f} s of it the gradient check, "
                  f"{train_s:.3f} s the steps")

        # whisper-base through the launcher: zero frames beside the tokens,
        # 4 steps uninterrupted, then 2 preempted and 2 resumed
        common = ["--arch", "whisper-base", "--seq-len", "1024",
                  "--global-batch", "4", "--log-every", "1", "--lr", "3e-4",
                  "--steps", "4"]
        t_launch = time.perf_counter()
        reset_launches()
        run_a = LT.main(common)
        hist_a = run_a["history"]
        launches = dict(LAUNCHES)
        del run_a
        free()

        class PreemptedAfterTwo(LT.Trainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                inner, done = self.step_fn, []

                def step_fn(state, batch):
                    res = inner(state, batch)
                    done.append(1)
                    if len(done) == 2:
                        self.request_preemption()
                    return res
                self.step_fn = step_fn

        with tempfile.TemporaryDirectory(dir=ROOT / "src" / "repro_torch"
                                         / "_build") as ckpt:
            LT.Trainer = PreemptedAfterTwo
            try:
                first = LT.main(common + ["--ckpt-dir", ckpt])
            finally:
                LT.Trainer = PreemptedAfterTwo.__bases__[0]
            check(first["preempted"] and first["last_step"] == 1,
                  f"whisper-base's preempted run stopped at "
                  f"{first['last_step']}")
            del first
            second = LT.main(common + ["--ckpt-dir", ckpt])
            hist_b = second["history"]
            del second
        free()
        pairs = [(a["loss"], b["loss"]) for a, b in zip(hist_a[2:], hist_b)]
        print(f"[34] whisper-base through launch.train (4 x 1024 tokens, "
              f"zero frames of 4 x {ARCHS['whisper-base'].encoder.num_frames}"
              f"): losses " + ", ".join(f"{r['loss']:.6f}" for r in hist_a)
              + f"; launches {launches}; preempted after 2 steps and "
              f"resumed: " + ", ".join(
                  f"{b:.6f} (uninterrupted {a:.6f})" for a, b in pairs)
              + f"; bit-equal: {all(a == b for a, b in pairs)}; "
              f"{time.perf_counter() - t_launch:.3f} s for the three runs")
        check([r["step"] for r in hist_b] == [2, 3]
              and all(a == b for a, b in pairs),
              "whisper-base's resumed losses differ from the uninterrupted "
              "run's")
        key = "whisper-base through launch.train, 4 steps (phase 34)"
        out["k5"][key] = launches["flash_attention"]
        out["k5_bwd"][key] = launches["flash_attention_bwd"]
        out["k5_bwd_wgmma"][key] = launches["flash_attention_bwd_wgmma"]
        per_fwd = k5_counts(ARCHS["whisper-base"])[0]
        check(launches["flash_attention"] == 4 * 2 * per_fwd
              == launches["flash_attention_wgmma"]
              and launches["flash_attention_bwd"] == 4 * per_fwd
              == launches["flash_attention_bwd_wgmma"],
              f"whisper-base's 4 launcher steps launched {launches}")
    return out


# phase 35: the dry-run's cells on the meta device, but four, which keeps
# the sweep near half a minute (79 s with all but the first two on the
# H100's host): recurrentgemma-9b's train_4k and prefill_32k (its RG-LRU
# scan is a Python loop over T, counted op by op on meta, about 0.5 ms an
# op: some 7 minutes a cell with the depth fit) and the two largest train
# steps (about 19 s each there); `python -m repro_torch.launch.dryrun
# --all` runs all 40.
SWEEP_LEFT_OUT = {("recurrentgemma-9b", "train_4k"):
                  "RG-LRU loop over 4096 steps, ~7 min on meta",
                  ("recurrentgemma-9b", "prefill_32k"):
                  "RG-LRU loop over 32768 steps, ~7 min on meta",
                  ("nemotron-4-340b", "train_4k"):
                  "96 layers forward, recomputed and backward, ~19 s",
                  ("deepseek-v2-236b", "train_4k"):
                  "60 MLA + MoE layers, ~19 s"}
# phase 36: the dry-run held against the card at full width, each cell cut
# in batch only: (arch, shape, variant, global batch)
PLAN_CELLS = (("qwen3-0.6b", "train_4k", "baseline", 1),
              ("qwen3-0.6b", "decode_32k", "w8", 8),
              ("falcon-mamba-7b", "prefill_32k", "baseline", 1),
              ("falcon-mamba-7b", "decode_32k", "w4", 8))
# the measured peak (torch.cuda.max_memory_allocated over the allocation
# before the arguments) against the predicted argument + temporary bytes:
# within 2% + 256 MiB either way. The caching allocator rounds each block
# up to 512 bytes (a few MB over a step's thousands of small tensors) and
# cuBLAS keeps a workspace per handle and stream (32 MiB on Hopper), which
# the count cannot see; 2% leaves room for the allocator's other blocks.
PEAK_REL, PEAK_ABS = 0.02, 256 * 2 ** 20


class KernelAudit:
    """Holds the first launch of each distinct call of K2, K5, K5's
    backward, K6 and K6's backward that a run makes (the kernel, its
    shapes, dtype and mask) element by element against the kernel's plain
    version on that launch's own inputs, under the tolerances the earlier
    phases hold each kernel to: `flash_attention_bound` (and
    `flash_attention_lse_tolerance` on the lse autograd keeps),
    `flash_attention_bwd_tolerance`, `ssm_scan_tolerance`,
    `ssm_scan_bwd_tolerance` and `quant_matmul_tolerance`. It also checks
    that each audited K5 launch took the body `takes_wgmma` (or
    `takes_wgmma_bwd`) names, each K2 launch the body `body_for` names
    (and on a packed payload the int4 body). The
    wrappers' launch functions are swapped for the run and put back after
    it; the plain versions launch nothing, so the run's counts stand."""

    def __init__(self, tag: str):
        self.tag = tag
        self.rows = {}

    def _record(self, key, name, shape, body, parts):
        import torch
        torch.cuda.synchronize()
        errs, shares = [], []
        for part, (got, ref, tol) in parts.items():
            err, share, ok = _within(got, ref, tol)
            check(ok and bool(torch.isfinite(got.float()).all()),
                  f"{self.tag}: {name} {shape} {part} differs from the "
                  f"plain version beyond the bound ({share:.3f} of it)")
            errs.append(err)
            shares.append(share)
        self.rows[key] = {"kernel": name, "shape": shape, "body": body,
                          "max_abs_err": max(errs),
                          "largest_share_of_bound": max(shares)}
        print(f"[{self.tag}] audit {name} {shape}, {body} body: max abs err "
              f"{max(errs):.3e}, largest share of the bound "
              f"{max(shares):.3f}")

    def __enter__(self):
        import torch
        from repro_torch.kernels import LAUNCHES
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import quant_matmul as QM
        from repro_torch.kernels import ssm_scan as SS
        from repro_torch.kernels.flash_attention import ops as FAO
        from repro_torch.kernels.quant_matmul import ops as QMO
        from repro_torch.kernels.ssm_scan import ops as SSO
        from repro_torch.nn import layers as L
        self.saved = [(FAO, "_launch_forward", FAO._launch_forward),
                      (FAO, "flash_attention_bwd", FAO.flash_attention_bwd),
                      (SSO, "_launch_forward", SSO._launch_forward),
                      (SSO, "ssm_scan_bwd", SSO.ssm_scan_bwd),
                      (L, "quant_matmul", L.quant_matmul)]
        fa_fwd, fa_bwd, ss_fwd, ss_bwd, qmm = (f for _, _, f in self.saved)

        def new(key, t):
            return t.device.type == "cuda" and key not in self.rows

        def k5(q, k, v, causal, window, softcap, with_lse=False):
            key = ("K5", tuple(q.shape), tuple(k.shape), q.dtype, causal,
                   window, softcap, with_lse)
            if not new(key, q):
                return fa_fwd(q, k, v, causal, window, softcap, with_lse)
            wgmma = FA.takes_wgmma(q, k, v)
            before = LAUNCHES["flash_attention_wgmma"]
            o, lse = fa_fwd(q, k, v, causal, window, softcap, with_lse)
            took = LAUNCHES["flash_attention_wgmma"] - before
            body = "wgmma" if took else "CUDA-core"
            check(took == int(wgmma), f"{self.tag}: K5 {key} took the "
                  f"{body} body, takes_wgmma says {wgmma}")
            kw = dict(causal=causal, window=window, softcap=softcap)
            with torch.no_grad():
                ref = FA.flash_attention_plain(q, k, v, **kw)
                parts = {"o": (o, ref, FA.flash_attention_bound(
                    q, k, v, ref, **kw))}
                if lse is not None:
                    lp = FA.flash_attention_lse_plain(q, k, v, **kw)
                    parts["lse"] = (lse, lp, FA.flash_attention_lse_tolerance(
                        q, k, lp, softcap=softcap))
                self._record(key, "flash_attention", key[1:3] + key[4:7]
                             + (str(q.dtype)[6:],) + (("lse",) if with_lse
                                                      else ()), body, parts)
            return o, lse

        def k5_bwd(q, k, v, o, do, lse, *, causal=True, window=0,
                   softcap=0.0):
            kw = dict(causal=causal, window=window, softcap=softcap)
            key = ("K5-bwd", tuple(q.shape), tuple(k.shape), q.dtype,
                   causal, window, softcap)
            if not new(key, q):
                return fa_bwd(q, k, v, o, do, lse, **kw)
            o_, do_ = (a if a.stride(-1) == 1 else a.contiguous()
                       for a in (o, do))
            wgmma = FA.takes_wgmma_bwd(q, k, v, o_, do_)
            before = LAUNCHES["flash_attention_bwd_wgmma"]
            got = fa_bwd(q, k, v, o, do, lse, **kw)
            took = LAUNCHES["flash_attention_bwd_wgmma"] - before
            body = "wgmma" if took else "CUDA-core"
            check(took == int(wgmma), f"{self.tag}: K5's backward {key} "
                  f"took the {body} body, takes_wgmma_bwd says {wgmma}")
            with torch.no_grad():
                ref = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
                tols = FA.flash_attention_bwd_tolerance(q, k, v, o, do, lse,
                                                        ref, **kw)
                self._record(key, "flash_attention_bwd", key[1:3] + key[4:]
                             + (str(q.dtype)[6:],), body,
                             {n: (a, b, t) for n, a, b, t in zip(
                                 ("dq", "dk", "dv"), got, ref, tols)})
            return got

        def k6(u, dt, B_, C_, A, D, with_states=False):
            key = ("K6", tuple(u.shape), A.shape[1], u.dtype, with_states)
            if not new(key, u):
                return ss_fwd(u, dt, B_, C_, A, D, with_states)
            out = ss_fwd(u, dt, B_, C_, A, D, with_states)
            y = out[0] if with_states else out
            with torch.no_grad():
                ref = SS.ssm_scan_ref(u, dt, B_, C_, A, D)
                self._record(key, "ssm_scan", key[1:3] + (str(u.dtype)[6:],)
                             + (("states",) if with_states else ()),
                             "CUDA-core", {"y": (y, ref, SS.ssm_scan_tolerance(
                                 u, dt, B_, C_, A, D, ref))})
            return out

        def k6_bwd(u, dt, B_, C_, A, D, dy, states):
            key = ("K6-bwd", tuple(u.shape), A.shape[1], u.dtype)
            if not new(key, u):
                return ss_bwd(u, dt, B_, C_, A, D, dy, states)
            got = ss_bwd(u, dt, B_, C_, A, D, dy, states)
            with torch.no_grad():
                ref = SS.ssm_scan_bwd_plain(u, dt, B_, C_, A, D, dy)
                tols = SS.ssm_scan_bwd_tolerance(u, dt, B_, C_, A, D, dy, ref)
                self._record(key, "ssm_scan_bwd", key[1:3]
                             + (str(u.dtype)[6:],), "CUDA-core",
                             {n: (a, b, t) for n, a, b, t in zip(
                                 ("du", "ddt", "dB_", "dC_", "dA", "dD"),
                                 got, ref, tols)})
            return got

        def k2(x, w_q, scales):
            key = ("K2", tuple(x.shape), tuple(w_q.shape), x.dtype,
                   w_q.dtype)
            if not new(key, x):
                return qmm(x, w_q, scales)
            want = QMO.body_for(
                x.shape[0], x.shape[1], scales.shape[0], x.dtype,
                w_q.dtype == torch.uint8,
                x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
            counts = ("quant_matmul_mma", "quant_matmul_wgmma",
                      "quant_matmul_int4")
            before = [LAUNCHES[c] for c in counts]
            y = qmm(x, w_q, scales)
            mma, wgmma, int4 = (LAUNCHES[c] - b
                                for c, b in zip(counts, before))
            body = ("int4 " if int4 else "") + (
                "wgmma" if wgmma else "mma" if mma else "CUDA-core")
            check(mma == int(want == "mma") and wgmma == int(want == "wgmma")
                  and int4 == int(w_q.dtype == torch.uint8),
                  f"{self.tag}: K2 {key} took the {body} body, not {want}")
            with torch.no_grad():
                ref = QM.quant_matmul_ref(x, w_q, scales)
                self._record(key, "quant_matmul", key[1:3]
                             + (str(x.dtype)[6:], str(w_q.dtype)[6:]), body,
                             {"y": (y, ref, QM.quant_matmul_tolerance(
                                 x, w_q, scales, ref))})
            return y

        for (mod, name, _), fn in zip(self.saved,
                                      (k5, k5_bwd, k6, k6_bwd, k2)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def by_kernel(self):
        """{kernel: (launches audited, max abs err, largest share)}."""
        out = {}
        for r in self.rows.values():
            n, e, sh = out.get(r["kernel"], (0, 0.0, 0.0))
            out[r["kernel"]] = (n + 1, max(e, r["max_abs_err"]),
                                max(sh, r["largest_share_of_bound"]))
        return out

# the kernels `KernelAudit` holds against their plain versions, by the
# name of their launch count
AUDITED = ("flash_attention", "flash_attention_bwd", "ssm_scan",
           "ssm_scan_bwd", "quant_matmul")


def audited_all(audit, launches, what):
    """Check that every audited kind of kernel ``launches`` counts had a
    launch held against its plain version by ``audit``."""
    missing = [k for k in AUDITED
               if launches.get(k) and k not in audit.by_kernel()]
    check(not missing, f"{what}: {missing} launched but not held against "
          f"the plain version")


def planning_sweep(card: str):
    """Phase 35: `launch.dryrun.run_cell` for every arch x shape of the
    registry but `SWEEP_LEFT_OUT`, on the meta device: status, the H100
    roofline's t_step and dominant term, the arguments' and temporaries'
    GiB against the card's 80 GB; each fit equal to the direct count."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline.hw import H100
    out = {}
    with Phase(35, "dry-run sweep on the meta device"):
        for arch in ARCHS:
            for shape_name in SHAPES:
                if (arch, shape_name) in SWEEP_LEFT_OUT:
                    print(f"[35] {arch} x {shape_name}: left out, "
                          f"{SWEEP_LEFT_OUT[(arch, shape_name)]}")
                    continue
                t0 = time.perf_counter()
                rec = D.run_cell(arch, shape_name, "single")
                wall = time.perf_counter() - t0
                check(rec["status"] in ("ok", "skipped"),
                      f"dry-run {arch} x {shape_name}: {rec['status']}")
                if rec["status"] == "skipped":
                    print(f"[35] {arch} x {shape_name}: skipped "
                          f"({rec['reason'][:60]}...)")
                    continue
                check(rec["fit"]["matches_direct"],
                      f"dry-run {arch} x {shape_name}: the depth fit "
                      f"differs from the direct count")
                r, m = rec["roofline"], rec["memory"]
                out[(arch, shape_name)] = rec
                print(f"[35] {card}: {arch} x {shape_name}: t_step "
                      f"{r['t_step_s']:.6g} s ({r['dominant']}; compute "
                      f"{r['t_compute_s']:.6g} s, memory "
                      f"{r['t_memory_s']:.6g} s), arguments "
                      f"{m['argument_bytes'] / 2 ** 30:.3f} GiB + "
                      f"temporaries {m['temp_bytes'] / 2 ** 30:.3f} GiB "
                      f"against {H100.hbm_bytes / 1e9:.0f} GB "
                      f"(fits: {rec['fits_hbm']}), useful FLOPs "
                      f"{rec['useful_flops_ratio']:.3f}, counted in "
                      f"{wall:.2f} s")
    return out


def planning_cells(card: str, dev):
    """Phase 36: `PLAN_CELLS` counted on meta (the prediction), then the
    same step on the card at the same shapes under the same counter: the
    FLOPs and each kernel's analytic record equal to the meta count, the
    peak within `PEAK_REL`/`PEAK_ABS` of the predicted arguments and
    temporaries, the median step time beside the roofline's t_step; then
    one more step under a `KernelAudit`, which holds the first launch of
    each distinct kernel call against its plain version. Returns the
    kernels' launches, the cells' numbers and the audit."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    out = {"launches": {}, "cells": {}, "audit": KernelAudit("36")}
    with Phase(36, "dry-run against the card"):
        for arch, shape_name, variant, batch in PLAN_CELLS:
            cfg = D.cell_config(arch, variant)
            shape = D.cell_shape(shape_name, batch)
            _, bits, kv = D.VARIANTS[variant]
            bits, kv = (bits, kv) if shape.kind == "decode" else (None, None)
            key = f"{arch} {shape_name} {variant} B={batch}"
            reset_launches()
            step, args = D.lower_cell(cfg, shape, serve_bits=bits,
                                      kv_dtype=kv)
            meta = RA.count_step(step, *args)
            check(sum(LAUNCHES.values()) == 0,
                  f"{key}: the meta count launched a kernel")
            pred_mem = RA.memory_dict(meta)
            pred = RA.Roofline(meta.counter.flops, meta.counter.bytes, 0)
            del step, args
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            step, args = D.lower_cell(cfg, shape, serve_bits=bits,
                                      kv_dtype=kv, device=dev, seed=36)
            torch.cuda.synchronize()
            args_measured = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            real = RA.count_step(step, *args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            launches = {k: v for k, v in LAUNCHES.items() if v}
            del real.result
            check(real.counter.flops == meta.counter.flops,
                  f"{key}: {real.counter.flops} FLOPs counted on the card, "
                  f"{meta.counter.flops} on meta")
            check(real.counter.kernels == meta.counter.kernels,
                  f"{key}: kernel records differ: {real.counter.kernels} "
                  f"on the card, {meta.counter.kernels} on meta")
            for name, rec in real.counter.kernels.items():
                check(launches.get(name) == rec["launches"],
                      f"{key}: {name} recorded {rec['launches']} launches, "
                      f"launched {launches.get(name)}")
            check(launches, f"{key}: no kernel launched")
            predicted = pred_mem["argument_bytes"] + pred_mem["temp_bytes"]
            slack = PEAK_REL * predicted + PEAK_ABS
            print(f"[36] {card}: {key}: FLOPs {real.counter.flops} on the "
                  f"card = {meta.counter.flops} on meta; bytes "
                  f"{real.counter.bytes} (meta {meta.counter.bytes}); "
                  f"kernels {real.counter.kernels}")
            print(f"[36] {card}: {key}: arguments "
                  f"{pred_mem['argument_bytes'] / 2 ** 30:.4f} GiB "
                  f"predicted, {args_measured / 2 ** 30:.4f} GiB "
                  f"allocated; peak {peak / 2 ** 30:.4f} GiB measured, "
                  f"{predicted / 2 ** 30:.4f} GiB predicted "
                  f"(arguments + temporaries {pred_mem['temp_bytes'] / 2 ** 30:.4f}"
                  f" GiB; the card's own count "
                  f"{RA.memory_dict(real)['temp_bytes'] / 2 ** 30:.4f}), "
                  f"measured/predicted {peak / predicted:.4f}")
            check(abs(peak - predicted) <= slack,
                  f"{key}: peak {peak} bytes, predicted {predicted} "
                  f"(bound {slack:.0f})")
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = step(*args)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                del res
            med = sorted(ms)[len(ms) // 2]
            # the kernels at this cell's shapes, each distinct call held
            # against its plain version (after the peak and the times)
            with out["audit"]:
                res = step(*args)
                torch.cuda.synchronize()
            del res
            audited_all(out["audit"], launches, key)
            print(f"[36] {card}: {key}: median step {med:.3f} ms over 5, "
                  f"roofline t_step {pred.t_step * 1e3:.3f} ms "
                  f"({pred.dominant}), measured/roofline "
                  f"{med / (pred.t_step * 1e3):.3f}")
            out["launches"][key] = launches
            out["cells"][key] = {
                "flops": real.counter.flops, "bytes": real.counter.bytes,
                "meta_bytes": meta.counter.bytes,
                "predicted_peak": predicted, "peak": peak,
                "argument_bytes": pred_mem["argument_bytes"],
                "median_ms": med, "t_step_ms": pred.t_step * 1e3,
                "dominant": pred.dominant}
            del step, args, real, meta
            gc.collect()
            torch.cuda.empty_cache()
    return out


def planning_examples(card: str, dev):
    """Phase 37: the four LM examples through their entry points
    (``python -m repro_torch.examples.<name>`` runs the same ``main``),
    each with its own check, under one `KernelAudit`. Returns the kernels'
    launches by example and the audit."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.examples import (lm_compression, quickstart,
                                      serve_demo, train_lm_100m)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.roofline.hw import H100
    launches = {}
    audit = KernelAudit("37")
    with Phase(37, "the LM examples"), audit:
        reset_launches()
        lm = lm_compression.main([])
        launches["lm_compression"] = dict(LAUNCHES)
        check(lm["front"] and np.isfinite(lm["speedup"]) and
              lm["speedup"] >= 1.0, f"lm_compression: {lm}")
        print(f"[37] {card}: lm_compression: {lm['n_groups']} groups, bf16 "
              f"baseline loss {lm['base_loss']:.4f} at "
              f"{lm['base_cost_us']:.6f} us/token on {H100.name}, front "
              f"{lm['front']}, projected decode speed-up "
              f"{lm['speedup']:.3f}x")
        reset_launches()
        qs = quickstart.main([])
        launches["quickstart"] = dict(LAUNCHES)
        for name, row in qs["techniques"].items():
            check(row["gain"] > 1.0 and 0 <= row["accuracy"] <= 1,
                  f"quickstart {name}: {row}")
        print(f"[37] {card}: quickstart area gains " + ", ".join(
            f"{k} {v['gain']:.3f}x (acc {v['accuracy']:.3f})"
            for k, v in qs["techniques"].items()))
        reset_launches()
        sd = serve_demo.main([])
        launches["serve_demo"] = dict(LAUNCHES)
        for arch, row in sd.items():
            for mode in ("dense", "w8"):
                check(row[mode]["tokens"] == 6 * 8,
                      f"serve_demo {arch} {mode}: {row[mode]['tokens']} "
                      f"tokens")
        reset_launches()
        with tempfile.TemporaryDirectory(dir=ROOT / "src" / "repro_torch"
                                         / "_build") as tmp:
            tl = train_lm_100m.main(["--steps", "30", "--ckpt-dir", tmp,
                                     "--log-every", "5"])
        launches["train_lm_100m"] = dict(LAUNCHES)
        check(tl["final_loss"] < tl["first_loss"],
              f"train_lm_100m: loss {tl['first_loss']} -> "
              f"{tl['final_loss']}")
        print(f"[37] {card}: train_lm_100m {tl['params'] / 1e6:.1f}M "
              f"params, 30 steps: loss {tl['first_loss']:.4f} -> "
              f"{tl['final_loss']:.4f} in {tl['wall_s']:.2f} s")
        for name, got in launches.items():
            print(f"[37] launches in {name}: "
                  f"{ {k: v for k, v in got.items() if v} }")
        check(launches["quickstart"]["netlist_sim"] > 0,
              "quickstart launched no K1")
        for name in ("lm_compression", "train_lm_100m"):
            check(launches[name]["flash_attention"] > 0 and
                  launches[name]["flash_attention_bwd"] > 0,
                  f"{name} launched no K5 forward or backward")
        for k in ("flash_attention", "ssm_scan", "quant_matmul"):
            check(launches["serve_demo"][k] > 0,
                  f"serve_demo launched no {k}")
        for name, got in launches.items():
            audited_all(audit, got, f"examples.{name}")
    return launches, audit


def gradient_compression(card: str, dev):
    """Phase 38: `dist.grad_compression` over qwen3-0.6b's real gradient
    trees (4 batches of 2 x 512 tokens, through K5): every leaf of the
    first round within half its step of the gradient, and after 4 rounds
    the sent sum plus the residual equal to the true sum; K5's launches
    held against its plain version by a `KernelAudit`. Returns K5's
    launches and the audit."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.dist import grad_compression as GC
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.nn import transformer as T
    from repro_torch.train import losses
    from repro_torch.train.optimizer import tree_leaves
    with Phase(38, "gradient compression"):
        cfg = ARCHS["qwen3-0.6b"]
        gen = torch.Generator(device=dev).manual_seed(38)
        params = T.init(gen, cfg, device=dev)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        reset_launches()
        grads = []
        audit = KernelAudit("38")
        with audit:
            for i in range(4):
                tokens = torch.randint(0, cfg.vocab_size, (2, 512),
                                       generator=gen, device=dev)
                logits, aux = T.forward(params, {"tokens": tokens}, cfg)
                loss = losses.next_token_loss(logits, tokens, aux=aux)
                grads.append([g.detach() for g in
                              torch.autograd.grad(loss, leaves)])
                del logits, loss
        launches = dict(LAUNCHES)
        audited_all(audit, launches, "qwen3-0.6b gradients")
        check(launches["flash_attention_bwd"] == 4 * 28,
              f"gradients took {launches['flash_attention_bwd']} K5 "
              f"backward launches")
        err = GC.init_error_state(grads[0])
        true_sum = [torch.zeros_like(e) for e in err]
        sent_sum = [torch.zeros_like(e) for e in err]
        worst = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, g in enumerate(grads):
            sent, err = GC.compress_tree(g, err)
            for i, (gi, si) in enumerate(zip(g, sent)):
                if k == 0:
                    # the step compress_tree took: of the float32 leaf (a
                    # bf16 leaf's own amax / 127 rounds in bf16)
                    _, scale = GC.quantize_leaf(gi.float())
                    slack = 4 * torch.finfo(torch.float32).eps * \
                        gi.float().abs().max()
                    dev_ = (gi.float() - si).abs().max()
                    worst = max(worst, float(dev_ / (scale / 2 + slack)))
                true_sum[i] += gi.float()
                sent_sum[i] += si
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
        check(worst <= 1.0, f"a leaf of round 1 off by {worst} of half "
              f"its step")
        gap = max(float((s + e - t).abs().max() /
                        t.abs().max().clamp_min(1e-30))
                  for s, e, t in zip(sent_sum, err, true_sum))
        check(gap <= 1e-5, f"error feedback: sent + residual off the true "
              f"sum by {gap} of its largest value")
        n = sum(g.numel() for g in grads[0])
        print(f"[38] {card}: qwen3-0.6b, {len(grads[0])} leaves, "
              f"{n} values a round: round 1 within {worst:.4f} of half a "
              f"step (worst leaf); after 4 rounds sent + residual = true "
              f"sum within {gap:.3g} relative; 4 rounds compressed in "
              f"{compress_s:.3f} s (float32 wire {4 * n / 2 ** 20:.1f} MiB, "
              f"int8 {n / 2 ** 20:.1f} MiB)")
        del grads, params, leaves
    return launches, audit


def main() -> None:
    t_main = time.perf_counter()
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
        # 15100 int64 slots: over 227 KB at one sample a block
        past_smem = [circuit.compile_netlist(synth_compiled(
            MZ, (16, 40, 40, 10), 8, seed=9))]
        rng = np.random.default_rng(0)
        cases = {  # name: (netlists, x, the body the shape takes)
            "real_mixed_whitewine": ([n for n, _ in real], xq_real, "smem"),
            "many_levels": (deep, rng.integers(0, 256, (1000, 11)), "smem"),
            "int64_lanes": (wide, rng.integers(0, 256, (513, 11)), "smem"),
            "ragged_batch_197": (ragged, rng.integers(0, 256, (197, 11)),
                                 "smem"),
            "ragged_batch_1": (ragged, rng.integers(0, 256, (1, 11)), "smem"),
            "past_smem": (past_smem, rng.integers(0, 256, (300, 16)),
                          "global"),
        }
        max_err = 0
        limits = NSO.device_limits(dev)
        for name, (nets, x, body) in cases.items():
            pop = NS.pack_population(nets)
            lane = 4 if NSO.lane_dtype(pop) == torch.int32 else 8
            tile = NSO.smem_tile(pop.n_candidates, pop.n_slots, x.shape[-2],
                                 lane, *limits)
            reset_launches()
            got = NS.simulate_population(pop, x, engine="cuda", device=dev)
            torch.cuda.synchronize()
            took = "smem" if LAUNCHES["netlist_sim_smem"] else "global"
            check(LAUNCHES["netlist_sim"] == 1, f"{name}: not one launch")
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
                  f"B={x.shape[-2]} lanes={NSO.lane_dtype(pop)} body={took} "
                  f"tile={tile} bit_exact={exact}")
            check(exact, f"netlist_sim kernel disagrees on {name}")
            check(took == body, f"netlist_sim {name} took the {took} body, "
                  f"not the {body} body")
        check(NSO.lane_dtype(NS.pack_population(wide)) == torch.int64,
              "int64 case did not take int64 lanes")
        check(len(xq_real[0]) % NSO.BLOCK != 0, "whitewine batch is a multiple")
        check(len(xq_real[0]) % 16 != 0, "whitewine batch is a tile multiple")

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
        check(launches["netlist_sim_smem"] == launches["netlist_sim"],
              f"{launches['netlist_sim'] - launches['netlist_sim_smem']} "
              f"netlist_sim launches of the search took the global body")
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
        check(staged.tile is not None, "the search's largest launch does "
              "not take the shared-memory body")
        # the global-scratch body where its shape takes it: phase 3's
        # population past the shared memory of a block
        big_pop = NS.pack_population(past_smem)
        big_x = torch.as_tensor(np.broadcast_to(
            cases["past_smem"][1], (big_pop.n_candidates,)
            + cases["past_smem"][1].shape).copy(), device=dev)
        staged_global = NSO.StagedLaunch(big_pop, big_x)
        check(staged_global.tile is None, "the population past the shared "
              "memory of a block does not take the global body")
        # device times from CUDA graphs of 50 launches (an eager loop reads
        # the host's cost of each call once the kernel is shorter), the
        # eager loops' beside them
        ms = _graph_ms(staged.launch, [()], reps=50)
        global_ms = _graph_ms(staged_global.launch, [()], reps=50)
        eager_ms = event_ms(staged.launch, reps=50)
        global_eager_ms = event_ms(staged_global.launch, reps=50)
        plain_ms = event_ms(lambda: NSO.simulate_levels(pop, x), reps=5,
                            warmup=1)
        global_plain_ms = event_ms(
            lambda: NSO.simulate_levels(big_pop, big_x), reps=3, warmup=1)
        big_shape = (f"P={big_pop.n_candidates} N={big_pop.n_slots} "
                     f"B={big_x.shape[1]} {NSO.lane_dtype(big_pop)}")
        lane = 4 if NSO.lane_dtype(pop) == torch.int32 else 8
        # every computed slot once a sample; tables, x and the outputs
        # moved once: the wrapper's own counts (`netlist_sim.ops.cost`)
        ops, nbytes = NSO.cost(pop, B, lane, smem=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[5] {card}: netlist_sim at P={P} N={pop.n_slots} B={B} "
              f"levels={int(pop.n_levels.max())} "
              f"lanes={NSO.lane_dtype(pop)}: kernel (shared-memory body, "
              f"tile {staged.tile}) {ms:.4f} ms on the device (eager "
              f"{eager_ms:.4f}), plain levels {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({nbytes} bytes, {ops} integer ops); "
              f"{ms / bound_ms:.0f}x the bound")
        print(f"[5] {card}: netlist_sim global-scratch body at {big_shape} "
              f"(phase 3's population past a block's shared memory): "
              f"{global_ms:.4f} ms on the device (eager "
              f"{global_eager_ms:.4f}), plain levels {global_plain_ms:.4f} "
              f"ms")
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
        "body": "CUDA cores: level-parallel walk of a (candidate, tile of "
                "samples) block in shared memory, one barrier a level; "
                "populations past 227 KB: one thread per (candidate, "
                "sample) through device memory",
        "replaces": "src/repro/kernels/netlist_sim/kernel.py:80",
        "launches": launches["netlist_sim"],
        "launches_smem_body": launches["netlist_sim_smem"],
        "max_abs_err": max_err, "tolerance": 0, "bit_exact": max_err == 0,
        "shapes": f"P={P} N={pop.n_slots} B={B} {NSO.lane_dtype(pop)}, "
                  f"tile {staged.tile}",
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
        "global_body": {"shapes": big_shape, "ms": global_ms,
                        "eager_ms": global_eager_ms,
                        "plain_ms": global_plain_ms},
        "bound_ms": bound_ms,
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
    gc.collect()
    torch.cuda.empty_cache()        # the falcon-mamba-7b tensors are gone
    w4 = w4_serving(card, dev)
    qmm_entry["launches_by_path"].update(w4["k2"])
    qmm_entry["launches_int4_body"] = sum(w4["k2"].values())
    qmm_entry["max_abs_err"] = max(qmm_entry["max_abs_err"],
                                   w4["max_abs_err"])
    qmm_entry["int4_body"] = {
        "body": "packed 4-bit payload, two weights a byte, unpacked in "
                "registers: bf16 x on mma.sync, float32 x on the CUDA "
                "cores",
        "largest_share_of_bound": w4["largest_share_of_bound"],
        "qwen3_layer": w4["qwen3_layer"],
        "falcon_mamba_step": w4["falcon_mamba_step"],
        "w4_decode": {a: w4[a] for a in W4_DECODE}}
    gc.collect()
    torch.cuda.empty_cache()
    wide = wide_products(card, dev)
    vision = wide["shapes"]["llama-3.2-vision cross K/V int8"]
    qmm_entry["wgmma_body"] = {
        "body": "large-M body for bf16 x: wgmma m64n128k16 or m64n160k16 "
                "with W^T from registers (int8 or packed int4 dequantized "
                "there) and x by TMA, 128 output columns by 128 or 160 "
                "rows a block over the whole of K, a producer warpgroup "
                "and a 6-stage ring",
        "entry_points": "quant_matmul_wide_bf16, quant_matmul_wide_int4_bf16",
        "shapes": "llama-3.2-vision's cross K/V projection, M 12808, K 4096, "
                  "N 1024, int8, one product",
        "ms": vision["ms"], "plain_ms": vision["plain_ms"],
        "bound_ms": vision["bound_ms"], "bound_by": vision["bound_by"],
        "library_ms": vision["library_ms"],
        "library": "torch.matmul on the dequantized bf16 weight",
        "decode_body_ms": vision["decode_body_ms"],
        "max_abs_err": wide["max_abs_err"],
        "largest_share_of_bound": wide["largest_share_of_bound"],
        "by_shape": wide["shapes"], "sweep": wide["sweep"],
        "threshold_measured": wide["threshold"],
        "calls_held_in_phase_42": wide["launches"]}
    qmm_entry["max_abs_err"] = max(qmm_entry["max_abs_err"],
                                   wide["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()
    k2_device, (cmm_entry, bsmm_entry) = compressed_products(card, dev)
    qmm_entry["device_ms_by_graph"] = k2_device
    # the qwen3-0.6b layer's times on the device (CUDA graphs, phase 21),
    # phase 11's eager loops beside them
    for key in ("ms", "plain_ms", "library_ms"):
        qmm_entry["eager_" + key] = qmm_entry[key]
        qmm_entry[key] = k2_device["qwen3_layer"][key]
    gc.collect()
    torch.cuda.empty_cache()        # the compressed products are gone
    paper_track = approximation_path(card, dev)
    netlist_entry["launches_by_path"] = {
        "whitewine search (phase 4)": netlist_entry["launches"],
        "whitewine search with approximation genes (phase 23)":
            paper_track["search"]["launches"]["netlist_sim"],
        "fig1 sweeps on whitewine (phase 24)":
            paper_track["fig1"]["launches"]["netlist_sim"]}
    netlist_entry["launches"] = sum(netlist_entry["launches_by_path"].values())
    netlist_entry["launches_smem_body"] += (
        paper_track["search"]["launches"]["netlist_sim_smem"]
        + paper_track["fig1"]["launches"]["netlist_sim_smem"])
    netlist_entry["approximated_population"] = \
        paper_track["approx_population"]
    islands = island_search(card, dev)
    netlist_entry["launches_by_path"][
        "island search: runs A, B, C and the front's checks (phase 25)"] = \
        islands["launches"]["netlist_sim"]
    netlist_entry["launches"] += islands["launches"]["netlist_sim"]
    netlist_entry["launches_smem_body"] += \
        islands["launches"]["netlist_sim_smem"]
    gc.collect()
    torch.cuda.empty_cache()
    bwd_entries, training = lm_training(card, dev)
    # the training paths also run the forward kernels
    fa_entry["launches_by_path"] = {
        "qwen3-0.6b prefill (phase 8)": fa_entry["launches"],
        "qwen3-0.6b training, 4 steps (phase 27)":
            training["launches_qwen3"]["flash_attention"]}
    fa_entry["launches"] = sum(fa_entry["launches_by_path"].values())
    fa_entry["launches_wgmma_body"] += \
        training["launches_qwen3"]["flash_attention_wgmma"]
    ssm_entry["launches_by_path"] = {
        "falcon-mamba-7b prefill (phase 14)": ssm_entry["launches"],
        "falcon-mamba-7b training, 3 steps (phase 27)":
            training["launches_falcon_mamba"]["ssm_scan"]}
    ssm_entry["launches"] = sum(ssm_entry["launches_by_path"].values())
    print(f"[27] {card}: training " + ", ".join(
        f"{k}: {v}" for k, v in training.items()
        if not k.startswith("launches")))
    gc.collect()
    torch.cuda.empty_cache()        # the training states are gone
    hybrid = hybrid_serving(card, dev)
    mla_cross = mla_cross_serving(card, dev)
    # every K5 launch of phases 28-33 was checked to take the wgmma body
    for part in (hybrid, mla_cross):
        fa_entry["launches_by_path"].update(part["k5"])
        fa_entry["launches_wgmma_body"] += sum(part["k5"].values())
        qmm_entry["launches_by_path"].update(part["k2"])
    # the w8 steps' cross K and V projections through the large-M body
    qmm_entry["wgmma_body"]["launches_by_path"] = {
        k: v for part in (hybrid, mla_cross)
        for k, v in part["k2_wgmma"].items() if v}
    qmm_entry["wgmma_body"]["launches"] = \
        qmm_entry["launches_wgmma_body"] = sum(
            qmm_entry["wgmma_body"]["launches_by_path"].values())
    check(qmm_entry["launches_wgmma_body"] > 0,
          "no launch of K2's large-M body on the w8 decode paths")
    gc.collect()
    torch.cuda.empty_cache()
    families = family_training(card, dev)
    fa_entry["launches_by_path"].update(families["k5"])
    fa_entry["launches_wgmma_body"] += sum(families["k5"].values())
    fa_entry["launches"] = sum(fa_entry["launches_by_path"].values())
    fa_entry["mla_shape"] = mla_cross["k5_mla"]
    bwd_fa = bwd_entries[0]
    bwd_fa["launches_by_path"] = {
        "qwen3-0.6b training, 4 steps (phase 27)": bwd_fa["launches"]}
    bwd_fa["launches_by_path"].update(families["k5_bwd"])
    bwd_fa["launches"] = sum(bwd_fa["launches_by_path"].values())
    bwd_fa["launches_wgmma_body"] += sum(families["k5_bwd_wgmma"].values())
    bwd_fa["family_shapes"] = families["k5_bwd_ms"]
    bwd_fa["max_abs_err"] = max([bwd_fa["max_abs_err"]] + [
        r["max_abs_err"] for r in families["k5_bwd_ms"].values()])
    bwd_fa["largest_share_of_bound"] = max(
        [bwd_fa["largest_share_of_bound"]]
        + [r["max_share"] for r in families["k5_bwd_ms"].values()])
    print(f"[34] {card}: training " + ", ".join(
        f"{k}: {v}" for k, v in families["train"].items()))
    qmm_entry["cross_projections"] = mla_cross["k2_cross"]
    gc.collect()
    torch.cuda.empty_cache()        # the family states are gone
    # phases 35-38: the planning path (dry-run, its cells on the card, the
    # LM examples, gradient compression)
    planning_sweep(card)
    cells = planning_cells(card, dev)
    examples, examples_audit = planning_examples(card, dev)
    compressed, compressed_audit = gradient_compression(card, dev)
    runs = {f"{k} (phase 36)": v for k, v in cells["launches"].items()}
    runs.update({f"examples.{k} (phase 37)": v for k, v in examples.items()})
    runs["qwen3-0.6b gradients for compression (phase 38)"] = compressed
    by_entry = ((netlist_entry, "netlist_sim", "netlist_sim_smem",
                 "launches_smem_body"),
                (qmm_entry, "quant_matmul", "quant_matmul_int4",
                 "launches_int4_body"),
                (fa_entry, "flash_attention", "flash_attention_wgmma",
                 "launches_wgmma_body"),
                (bwd_fa, "flash_attention_bwd", "flash_attention_bwd_wgmma",
                 "launches_wgmma_body"),
                (ssm_entry, "ssm_scan", None, None))
    for entry, name, body, body_key in by_entry:
        for path, got in runs.items():
            if got.get(name):
                entry["launches_by_path"][path] = got[name]
                if body:
                    entry[body_key] += got.get(body, 0)
        entry["launches"] = sum(entry["launches_by_path"].values())
    fa_entry["planning_cells"] = cells["cells"]
    # phases 36-38's launches held against the plain versions, each
    # distinct call once
    by_name = {"flash_attention": fa_entry, "flash_attention_bwd": bwd_fa,
               "ssm_scan": ssm_entry, "ssm_scan_bwd": bwd_entries[1],
               "quant_matmul": qmm_entry}
    for phase, audit in ((36, cells["audit"]), (37, examples_audit),
                         (38, compressed_audit)):
        for name, (n, err, share) in audit.by_kernel().items():
            entry = by_name[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry.setdefault("audited_calls_by_phase", {})[str(phase)] = {
                "calls": n, "max_abs_err": err,
                "largest_share_of_bound": share}
    print(f"[end] all phases: {time.perf_counter() - t_main:.1f} s from the "
          f"script's start, the kernels' builds included")
    print(json.dumps({"kernels": [netlist_entry, qmm_entry, cmm_entry,
                                  bsmm_entry, fa_entry, ssm_entry]
                      + bwd_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
