"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    d_model=18432,
    vocab_size=256000,
    segments=(Segment((LayerSpec("attn", "dense"),), 96),),
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,                      # 18432 / 96
    d_ff=73728,
    mlp_type="relu2",                  # squared ReLU, no gating
    rope_theta=10000.0,
    source="arXiv:2402.16819; unverified",
)
