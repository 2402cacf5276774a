"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig, Segment

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    vocab_size=32064,
    segments=(Segment((LayerSpec("attn", "moe"),), 32),),
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400,
                  capacity_factor=1.25),
    rope_theta=10000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
