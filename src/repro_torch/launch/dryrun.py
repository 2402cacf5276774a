"""Dry-run on one H100: count every (arch x shape) cell on the meta device
and price it against the card, the counterpart of `repro.launch.dryrun`.

For each cell:
  1. The step at full depth, on meta tensors (`launch.specs`), under
     `roofline.analysis.count_step`: nothing is computed or allocated, the
     hand-written kernels take their meta branches and record their
     analytic costs. Records the memory (arguments, temporaries, ...), the
     FLOPs and bytes, and the collectives (none on one card).
  2. The affine fit over depth (`roofline.analysis.fit_depth`): the same
     count at repeats 1 and 1+e_i per depth knob. The port's segments loop
     over their repeats in Python, so the direct count is already exact;
     the fit is kept as the reference's method and must reproduce it
     (``fit.matches_direct``). A quantized variant whose stacked leaf
     crosses the quantizer's size threshold between the fitted depths and
     full depth is not affine in depth, and says so there.
  3. The three-term roofline on `roofline.hw.H100`, MODEL_FLOPS and the
     useful-FLOPs ratio; writes artifacts/dryrun_torch/<arch>__<shape>__
     <mesh>.json (existing files are skipped -> the sweep is resumable).

A cell is one card (``--mesh single``, ``chips: 1``); ``--mesh multi`` is
refused: the port runs on one card, with no pod. The times are the
roofline's, an ideal: a prediction to hold measured steps against.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import ArchConfig, Segment, ShapeConfig
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.nn import transformer as T
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.hw import H100
from repro_torch.train import train_state as TS
from repro_torch.train.optimizer import AdamWConfig

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# ---------------------------------------------------------------------------
# §Perf variants: named config/serving transforms for the hillclimb cells.
# Each entry: (cfg_transform, serve_weight_bits, kv_cache_dtype)
# ---------------------------------------------------------------------------

VARIANTS = {
    "baseline": (lambda c: c, None, None),
    # bf16 attention scores/probs on the plain (decode) attention
    "lowp_attn": (lambda c: dataclasses.replace(c, attn_lowp_probs=True),
                  None, None),
    # save matmul outputs under remat (trade memory for recompute)
    "remat_dots": (lambda c: dataclasses.replace(c, remat_policy="dots"),
                   None, None),
    "lowp_dots": (lambda c: dataclasses.replace(
        c, attn_lowp_probs=True, remat_policy="dots"), None, None),
    # EP-local MoE routing
    "moe_ps": (lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch="per_sample")), None, None),
    "moe_ps_lowp": (lambda c: dataclasses.replace(
        c, attn_lowp_probs=True,
        moe=dataclasses.replace(c.moe, dispatch="per_sample")), None, None),
    # paper technique on the serving path: intN weights (+ fp8 KV cache)
    "w8": (lambda c: c, 8, None),
    "w4": (lambda c: c, 4, None),
    "w8kv8": (lambda c: c, 8, "float8_e4m3fn"),
    "w4kv8": (lambda c: c, 4, "float8_e4m3fn"),
    # TP-only serving: quantized weights without FSDP
    "w8tp": (lambda c: c, 8, "float8_e4m3fn"),
    "w4tp": (lambda c: c, 4, "float8_e4m3fn"),
}

NO_FSDP_VARIANTS = {"w8tp", "w4tp"}


# ---------------------------------------------------------------------------
# depth knobs
# ---------------------------------------------------------------------------


def depth_knobs(cfg: ArchConfig):
    """Repeat counts the affine cost model fits over: one per segment, plus
    the encoder stack if present."""
    knobs = [seg.repeats for seg in cfg.segments]
    if cfg.encoder is not None:
        knobs.append(cfg.encoder.num_layers)
    return knobs


def with_depth(cfg: ArchConfig, repeats) -> ArchConfig:
    n_seg = len(cfg.segments)
    segs = tuple(Segment(s.pattern, int(r))
                 for s, r in zip(cfg.segments, repeats[:n_seg]))
    kw = {"segments": segs}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder,
                                            num_layers=int(repeats[n_seg]))
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# one variant's step and arguments
# ---------------------------------------------------------------------------


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, *, serve_bits=None,
               kv_dtype=None, device="meta", seed: int = 0):
    """(step, args) of one cell/variant. On ``device="meta"`` (the
    dry-run) the arguments are `launch.specs`'s abstract ones; on a real
    device the same step takes real ones: parameters drawn from ``seed``
    (`transformer.init`), zero moments and caches, random tokens, zero
    frames or patches, weights quantized with `serve.quantized`."""
    from repro_torch.serve import quantized as QS
    dev = torch.device(device)
    meta = dev.type == "meta"
    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(seed)
    inputs = SP.input_specs(cfg, shape)
    if not meta:
        inputs = {k: (torch.randint(0, cfg.vocab_size, v.shape,
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
                      if k == "tokens" else
                      torch.zeros(v.shape, dtype=v.dtype, device=dev))
                  for k, v in inputs.items()}
    if shape.kind == "train":
        state = TS.init_state(gen, cfg, AdamWConfig(), device=dev)
        return TS.make_train_step(cfg, AdamWConfig(), remat=True), \
            (state, inputs)
    params = T.init(gen, cfg, device=dev)
    if shape.kind == "prefill":
        return TS.make_prefill_step(cfg), (params, inputs)
    dstate = SP.abstract_decode_state(cfg, shape, kv_dtype=kv_dtype) if meta \
        else T.init_decode_state(
            cfg, shape.global_batch, shape.seq_len,
            kv_dtype or cfg.dtype, device=dev)
    if serve_bits:
        params = QS.abstract_quantized(params, serve_bits) if meta else \
            QS.quantize_params(params, serve_bits)
        step = QS.make_quant_serve_step(cfg)
    else:
        step = TS.make_serve_step(cfg)
    return step, (params, dstate, inputs["tokens"])


def measure_variant(cfg, shape, repeats, *, serve_bits=None,
                    kv_dtype=None) -> dict:
    """FLOPs, bytes and collective bytes of the step at ``repeats``,
    counted on meta."""
    step, args = lower_cell(with_depth(cfg, repeats), shape,
                            serve_bits=serve_bits, kv_dtype=kv_dtype)
    count = RA.count_step(step, *args)
    out = RA.cost_dict(count)
    out.update({f"coll_{k}": val for k, val in RA.collective_bytes(
        count.counter.collectives).items()})
    return out


# ---------------------------------------------------------------------------
# one cell, end to end
# ---------------------------------------------------------------------------


def cell_shape(shape_name: str, global_batch: Optional[int] = None
               ) -> ShapeConfig:
    shape = SHAPES[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    return shape


def cell_config(arch: str, variant: str = "baseline") -> ArchConfig:
    cfg = ARCHS[arch]
    transform = VARIANTS[variant][0]
    return transform(cfg) if (cfg.moe is not None or
                              not variant.startswith("moe")) else cfg


def run_cell(arch: str, shape_name: str, mesh_name: str = "single", *,
             skip_reduced: bool = False, variant: str = "baseline") -> dict:
    """One cell's record."""
    if mesh_name != "single":
        raise ValueError(f"mesh {mesh_name!r}: the port plans one card "
                         f"(--mesh single); there is no pod to shard over")
    shape = SHAPES[shape_name]
    _, serve_bits, kv_dtype = VARIANTS[variant]
    if shape.kind != "decode":
        serve_bits, kv_dtype = None, None
    cfg = cell_config(arch, variant)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = make_debug_mesh()
    chips = mesh.size
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "status": "ok", "variant": variant,
           "fsdp": variant not in NO_FSDP_VARIANTS, "device": H100.name}

    # 1. the step at full depth on meta: memory and the direct count
    t0 = time.time()
    step, args = lower_cell(cfg, shape, serve_bits=serve_bits,
                            kv_dtype=kv_dtype)
    count = RA.count_step(step, *args)
    rec["count_s"] = round(time.time() - t0, 2)
    rec["memory"] = RA.memory_dict(count)
    rec["cost_raw"] = RA.cost_dict(count)
    rec["coll_raw"] = RA.collective_bytes(count.counter.collectives)
    rec["kernels"] = count.counter.kernels
    # where the count comes from: the ops with the most FLOPs and bytes
    for key, by_op in (("flops_by_op", count.counter.flops_by_op),
                       ("bytes_by_op", count.counter.bytes_by_op)):
        rec[key] = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:8])
    direct = dict(rec["cost_raw"])
    direct.update({f"coll_{k}": v for k, v in rec["coll_raw"].items()})
    del count, step, args

    # 2. affine fit over depth -> full-depth roofline
    if not skip_reduced:
        knobs = depth_knobs(cfg)
        fit = RA.fit_depth(
            lambda r: measure_variant(cfg, shape, r, serve_bits=serve_bits,
                                      kv_dtype=kv_dtype),
            len(knobs))
        full = fit.at(knobs)
        roof = RA.Roofline(flops_per_chip=full["flops"],
                           bytes_per_chip=full["bytes"],
                           coll_bytes_per_chip=full.get("coll_total", 0.0))
        rec["fit"] = {"base": fit.base, "bodies": fit.bodies,
                      "knobs": knobs, "matches_direct": full == direct}
        rec["roofline"] = roof.as_dict()

        # MODEL_FLOPS ratio (useful-compute fraction)
        n_active = T.active_param_count(SP.abstract_params(cfg), cfg)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mf = RA.model_flops(n_active, tokens,
                            "train" if shape.kind == "train" else "serve")
        rec["model_flops"] = mf
        rec["n_active_params"] = n_active
        total = full["flops"] * chips
        rec["useful_flops_ratio"] = mf / total if total else 0.0
    mem = rec["memory"]
    rec["fits_hbm"] = mem["argument_bytes"] + mem["temp_bytes"] \
        <= H100.hbm_bytes
    return rec


def cells():
    for arch in ARCHS:
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-reduced", action="store_true",
                    help="full-depth count only (no depth fit)")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.error(f"--mesh {args.mesh}: the port plans one H100 (--mesh "
                 f"single); there is no pod to shard over")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        todo = list(cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in todo:
        suffix = "" if args.variant == "baseline" else f"__{args.variant}"
        path = out_dir / f"{arch}__{shape_name}__single{suffix}.json"
        if path.exists() and not args.force:
            print(f"[skip-existing] {path.name}")
            continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shape_name, "single",
                           skip_reduced=args.skip_reduced,
                           variant=args.variant)
        except Exception as e:  # record the failure, keep sweeping
            rec = {"arch": arch, "shape": shape_name, "mesh": "single",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            failures += 1
        rec["wall_s"] = round(time.time() - t0, 2)
        path.write_text(json.dumps(rec, indent=2))
        extra = ""
        if rec["status"] == "ok" and "roofline" in rec:
            r, m = rec["roofline"], rec["memory"]
            extra = (f" dom={r['dominant']} t_step={r['t_step_s']:.4g}s "
                     f"useful={rec['useful_flops_ratio']:.2f} "
                     f"args={m['argument_bytes'] / 2 ** 30:.2f}GiB "
                     f"temp={m['temp_bytes'] / 2 ** 30:.2f}GiB "
                     f"fit={rec['fit']['matches_direct']}")
        print(f"[{rec['status']}] {arch} x {shape_name} x single "
              f"({rec['wall_s']}s){extra}", flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
