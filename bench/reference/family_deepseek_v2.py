"""DeepSeek-V2's ``config.json`` keys -> `ModelSpec`.

Only the router that the port runs is accepted: plain greedy over one
group (``topk_method == "greedy"``, ``n_group == 1``; ``topk_group`` is
read only by group-limited greedy and keeps its published value), no
routed scaling, top-k weights renormalized, softmax scoring. RoPE is
plain: a YaRN group is accepted only at factor 1, where it leaves every
frequency and the softmax scale as they are."""
from __future__ import annotations

from .spec import MLA, MoE, ModelSpec, assumed


def spec(cfg: dict, name: str) -> ModelSpec:
    checks = {
        "n_group": 1, "topk_method": "greedy", "routed_scaling_factor": 1,
        "norm_topk_prob": True, "scoring_func": "softmax",
        "hidden_act": "silu", "attention_bias": False,
        "tie_word_embeddings": False, "moe_layer_freq": 1,
    }
    for key, want in checks.items():
        if cfg[key] != want:
            raise ValueError(f"{name}: {key} = {cfg[key]!r}; the port runs "
                             f"{want!r}")
    rs = cfg.get("rope_scaling")
    if rs is not None and float(rs.get("factor", 1)) != 1.0:
        raise ValueError(f"{name}: rope scaling at factor {rs['factor']}; "
                         f"the port runs plain RoPE")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError(f"{name}: MLA rebuilds k and v for every head")
    n_layers = cfg["num_hidden_layers"]
    n_dense = min(cfg["first_k_dense_replace"], n_layers)
    mla = MLA(q_lora_rank=cfg["q_lora_rank"],
              kv_lora_rank=cfg["kv_lora_rank"],
              qk_nope_head_dim=cfg["qk_nope_head_dim"],
              qk_rope_head_dim=cfg["qk_rope_head_dim"],
              v_head_dim=cfg["v_head_dim"])
    moe = MoE(num_experts=cfg["n_routed_experts"],
              top_k=cfg["num_experts_per_tok"],
              d_expert=cfg["moe_intermediate_size"],
              d_shared=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
              capacity_factor=float(assumed(cfg, "capacity_factor")))
    return ModelSpec(
        name=name, vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=mla.qk_nope_head_dim + mla.qk_rope_head_dim,
        n_dense=n_dense, n_moe=n_layers - n_dense,
        d_ff=cfg["intermediate_size"], rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]), mla=mla, moe=moe,
        dtype=assumed(cfg, "dtype"))
