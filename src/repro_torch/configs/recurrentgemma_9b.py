"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 rec : 1 local.
[arXiv:2402.19427 (Griffin); unverified]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, RGLRUConfig, Segment

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    vocab_size=256000,
    # 38 layers = (rec, rec, local) x 12 + (rec, rec)
    segments=(
        Segment((LayerSpec("rec", "dense"), LayerSpec("rec", "dense"),
                 LayerSpec("local", "dense")), 12),
        Segment((LayerSpec("rec", "dense"), LayerSpec("rec", "dense")), 1),
    ),
    num_heads=16,
    num_kv_heads=1,                    # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    mlp_type="geglu",
    window_size=2048,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4, c_exponent=8.0),
    norm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2402.19427; unverified",
    notes="sub-quadratic: RG-LRU state + O(window) ring cache -> long_500k runs",
)
