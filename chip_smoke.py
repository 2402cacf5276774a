#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``src/repro_torch/csrc`` with nvcc
   (build time and ``-Xptxas -v`` report printed);
3. hold each kernel against its plain PyTorch version and the numpy oracle
   on the card, bit for bit (netlist_sim: a real mixed-size WhiteWine
   population compiled by the port, a many-level population, an int64-lane
   population, batches that are not a block multiple);
4. the port's main path through its user entry point: the paper's
   hardware-aware search on WhiteWine (11-10-7, population 8, 3
   generations, 60 epochs) on CUDA, with every kernel's launch count read
   just after it; then the chosen point compiled and checked
   (netlist-exact accuracy == integer forward, structural == analytic cost);
5. times on the card (CUDA events) of each kernel and its plain version at
   the main path's shapes, beside the least time the card could take, and
   the device's busy share during the largest population finetune
   (``torch.profiler`` kernel time over the call's unprofiled wall time).

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

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

    # -- 2. build ---------------------------------------------------------
    # always from the sources in this checkout: drop a library left by an
    # earlier run, so the build (and its ptxas report) happens here
    build.library_path("netlist_sim").unlink(missing_ok=True)
    build.load("netlist_sim")
    info = build.BUILD_INFO["netlist_sim"]
    print(f"[2] built netlist_sim from source in {info['seconds']:.2f} s")
    print(info["log"].strip())

    # -- 3. kernel vs plain version vs oracle, bit for bit ---------------
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    a, kw = max(finetune_args, key=lambda t: t[0][1].shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finetune(*a, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        finetune(*a, **kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_s = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation) / 1e6
    n_kernels = sum(e.count for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    check(busy_s > 0, "the profiler saw no device time")
    print(f"[5] {card}: population finetune P={a[1].shape[0]} "
          f"(60 epochs): wall {wall_s:.3f} s, device busy {busy_s:.4f} s "
          f"in {n_kernels} kernels, busy share {busy_s / wall_s:.3f}")
    print(json.dumps({"kernels": [{
        "name": "netlist_sim", "route": "cuda",
        "source": "src/repro_torch/csrc/netlist_sim.cu",
        "replaces": "src/repro/kernels/netlist_sim/kernel.py:80",
        "launches": launches["netlist_sim"], "max_abs_err": max_err,
        "tolerance": 0, "bit_exact": max_err == 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
