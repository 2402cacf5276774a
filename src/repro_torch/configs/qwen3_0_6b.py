"""qwen3-0.6b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    d_model=1024,
    vocab_size=151936,
    segments=(Segment((LayerSpec("attn", "dense"),), 28),),
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-0.6B; hf",
)
