"""gemma2-2b [dense] — local/global alternation, logit softcaps, post-norms.
[arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    vocab_size=256000,
    # 26 layers: (local, global) x 13
    segments=(Segment((LayerSpec("local", "dense"),
                       LayerSpec("attn", "dense")), 13),),
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    mlp_type="geglu",
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norm=True,
    norm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2408.00118; hf",
    notes="global-attention half keeps the arch out of the sub-quadratic "
          "class; long_500k skipped (DESIGN.md §9)",
)
