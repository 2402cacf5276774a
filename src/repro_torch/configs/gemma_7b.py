"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    d_model=3072,
    vocab_size=256000,
    segments=(Segment((LayerSpec("attn", "dense"),), 28),),
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    mlp_type="geglu",
    norm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2403.08295; hf",
)
