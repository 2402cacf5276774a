"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
[arXiv:2405.04434]"""
from repro_torch.configs.base import (ArchConfig, LayerSpec, MLAConfig, MoEConfig,
                                Segment)

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    vocab_size=102400,
    # layer 0: dense FFN (intermediate 12288); layers 1..59: MoE
    segments=(
        Segment((LayerSpec("attn", "dense"),), 1),
        Segment((LayerSpec("attn", "moe"),), 59),
    ),
    num_heads=128,
    num_kv_heads=128,                  # MLA reconstructs per-head k/v
    head_dim=192,                      # qk_nope 128 + rope 64
    d_ff=12288,                        # dense layer intermediate
    mlp_type="swiglu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared=3072,
                  capacity_factor=1.25),
    rope_theta=10000.0,
    source="arXiv:2405.04434; hf",
    notes="decode uses the absorbed MLA form over the compressed c_kv cache",
)
