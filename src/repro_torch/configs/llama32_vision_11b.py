"""llama-3.2-vision-11b [vlm] — decoder with gated cross-attention image
layers every 5th layer; vision tower is a STUB (input_specs feeds precomputed
patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment, VisionConfig

_PERIOD = (
    LayerSpec("attn", "dense"),
    LayerSpec("attn", "dense"),
    LayerSpec("attn", "dense"),
    LayerSpec("cross", "dense"),       # gated cross-attn to patch embeddings
    LayerSpec("attn", "dense"),
)

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    vocab_size=128256,
    segments=(Segment(_PERIOD, 8),),   # 40 layers, 8 cross-attn
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    mlp_type="swiglu",
    rope_theta=500000.0,
    vision=VisionConfig(num_patches=1601),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
