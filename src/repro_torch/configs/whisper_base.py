"""whisper-base [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs feeds precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    d_model=512,
    vocab_size=51865,
    # decoder: 6 layers, each self-attn + cross-attn to encoder frames
    segments=(Segment((LayerSpec("cross", "dense"),), 6),),
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    use_rope=False,
    max_position_embeddings=32768,     # backbone shapes go to 32k (assigned
    # decode_32k); real whisper caps at 448 — noted backbone-only semantics
    encoder=EncoderConfig(num_layers=6, num_frames=1500),
    source="arXiv:2212.04356; unverified",
    notes="encoder-decoder: decode shapes exercise the decoder with "
          "cross-attention to stub frame embeddings",
)
