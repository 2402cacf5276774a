"""Phi-3.5-MoE's ``config.json`` keys -> `ModelSpec`.

The file states what the port runs where it departs from the model card
(``departures``): RMSNorm at ``rms_norm_eps`` for LayerNorm, no attention
or LM-head bias, a softmax top-k renormalized for SparseMixer, plain RoPE
for LongRoPE. This parser reads the run values: ``attention_bias`` and
``lm_head_bias`` false, ``rope_scaling`` null."""
from __future__ import annotations

from .spec import MoE, ModelSpec, assumed


def spec(cfg: dict, name: str) -> ModelSpec:
    for key in ("attention_bias", "lm_head_bias", "tie_word_embeddings"):
        if cfg.get(key):
            raise ValueError(f"{name}: {key} is set; the port runs none")
    if cfg.get("rope_scaling") is not None:
        raise ValueError(f"{name}: the port runs plain RoPE")
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{name}: hidden_act {cfg['hidden_act']!r}")
    d = cfg["hidden_size"]
    moe = MoE(num_experts=cfg["num_local_experts"],
              top_k=cfg["num_experts_per_tok"],
              d_expert=cfg["intermediate_size"], d_shared=0,
              capacity_factor=float(assumed(cfg, "capacity_factor")))
    return ModelSpec(
        name=name, vocab_size=cfg["vocab_size"], d_model=d,
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"],
        n_dense=0, n_moe=cfg["num_hidden_layers"], d_ff=0,
        rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
        mla=None, moe=moe, dtype=assumed(cfg, "dtype"))
