"""The program under test, `repro_torch`, seen from the benchmark: the
port's `ArchConfig` for a `ModelSpec`, and the benchmark's seeded weights
put into the port's parameter tree.

This is the one module of the harness that imports the port. The tree it
builds is checked, leaf for leaf, against the shapes and dtypes that the
port's own `transformer.init` gives on the meta device, so a change of the
port's layout fails here instead of running on misplaced weights."""
from __future__ import annotations

from typing import Dict

import torch

from bench.reference.spec import ModelSpec


def arch(spec: ModelSpec):
    """The port's ArchConfig for ``spec``."""
    from repro_torch.configs.base import (ArchConfig, LayerSpec, MLAConfig,
                                          MoEConfig, Segment)
    segs = []
    if spec.n_dense:
        segs.append(Segment((LayerSpec("attn", "dense"),), spec.n_dense))
    if spec.n_moe:
        segs.append(Segment((LayerSpec("attn", "moe"),), spec.n_moe))
    mla = moe = None
    if spec.mla is not None:
        m = spec.mla
        mla = MLAConfig(q_lora_rank=m.q_lora_rank,
                        kv_lora_rank=m.kv_lora_rank,
                        qk_nope_head_dim=m.qk_nope_head_dim,
                        qk_rope_head_dim=m.qk_rope_head_dim,
                        v_head_dim=m.v_head_dim)
    if spec.moe is not None:
        m = spec.moe
        moe = MoEConfig(num_experts=m.num_experts, top_k=m.top_k,
                        d_expert=m.d_expert,
                        num_shared_experts=m.d_shared // m.d_expert,
                        d_shared=m.d_shared,
                        capacity_factor=m.capacity_factor)
    if spec.rms_eps != 1e-6:
        raise ValueError(f"{spec.name}: the port's RMSNorm has eps 1e-6, "
                         f"not {spec.rms_eps}")
    return ArchConfig(
        name=spec.name, family="moe" if moe else "dense",
        d_model=spec.d_model, vocab_size=spec.vocab_size,
        segments=tuple(segs), num_heads=spec.num_heads,
        num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
        d_ff=spec.d_ff or (spec.moe.d_expert if spec.moe else 0),
        mlp_type="swiglu", mla=mla, moe=moe, rope_theta=spec.rope_theta,
        dtype=spec.dtype)


def _block(w: Dict[str, torch.Tensor], g: str, spec: ModelSpec) -> dict:
    k = lambda n: {"kernel": w[f"{g}.{n}"]}
    if spec.mla is not None:
        mixer = {"w_dq": k("w_dq"), "q_norm": {"scale": w[f"{g}.q_norm"]},
                 "w_uq": k("w_uq"), "w_dkv": k("w_dkv"),
                 "kv_norm": {"scale": w[f"{g}.kv_norm"]},
                 "w_uk": k("w_uk"), "w_uv": k("w_uv"), "w_kr": k("w_kr"),
                 "wo": k("wo")}
    else:
        mixer = {"wq": k("wq"), "wk": k("wk"), "wv": k("wv"), "wo": k("wo")}
    p = {"norm1": {"scale": w[f"{g}.norm1"]}, "mixer": mixer,
         "norm2": {"scale": w[f"{g}.norm2"]}}
    if g == "dense":
        p["mlp"] = {"wi_gate": k("ff_gate"), "wi_up": k("ff_up"),
                    "wo": k("ff_out")}
    else:
        p["moe"] = {"router": k("router"),
                    "experts": {"wi_gate": w["moe.e_gate"],
                                "wi_up": w["moe.e_up"],
                                "wo": w["moe.e_out"]}}
        if spec.moe.d_shared:
            p["moe"]["shared"] = {"wi_gate": k("s_gate"), "wi_up": k("s_up"),
                                  "wo": k("s_wo")}
    return p


def params(w: Dict[str, torch.Tensor], spec: ModelSpec, cfg) -> dict:
    """The port's parameter tree holding the tensors of ``w`` (no copy)."""
    tree = _tree(w, spec)
    check_layout(tree, cfg)
    return tree


def check_layout(tree, cfg) -> None:
    """Raise unless ``tree`` has the structure, shapes and dtypes of the
    port's own parameters for ``cfg``."""
    from repro_torch.nn import transformer as T
    want = dict(T._leaves(T.init(torch.Generator(), cfg, device="meta")))
    got = dict(T._leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter tree differs from the port's: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for path, t in want.items():
        g = got[path]
        if tuple(g.shape) != tuple(t.shape) or g.dtype != t.dtype:
            raise ValueError(f"{path}: {tuple(g.shape)} {g.dtype}, the port "
                             f"has {tuple(t.shape)} {t.dtype}")


def leaf_names(spec: ModelSpec) -> Dict[tuple, str]:
    """The port's leaf path -> the benchmark's leaf name."""
    from bench.harness import weights as WT
    from repro_torch.nn import transformer as T
    names = [leaf.name for leaf in WT.leaves(spec)]
    marker = {n: torch.empty(0) for n in names}
    tree = _tree(marker, spec)
    ids = {id(t): n for n, t in marker.items()}
    return {path: ids[id(t)] for path, t in T._leaves(tree)}


def _tree(w, spec: ModelSpec) -> dict:
    return {"embed": {"table": w["embed"]},
            "segments": tuple((_block(w, g, spec),)
                              for g, R in (("dense", spec.n_dense),
                                           ("moe", spec.n_moe)) if R),
            "final_norm": {"scale": w["final_norm"]},
            "lm_head": {"kernel": w["lm_head"]}}
