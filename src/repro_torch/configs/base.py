"""Architecture / shape configuration dataclasses (copied from
`repro.configs.base`).

Every assigned architecture is described by an :class:`ArchConfig`. Models are
assembled from *segments*: a segment is a repeating pattern of
:class:`LayerSpec` entries. Parameters stack along a leading ``repeats`` axis,
as in the JAX package; the port walks that axis with a Python loop.

Shapes (the four assigned input-shape cells) are :class:`ShapeConfig`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

MIXERS = ("attn", "local", "rec", "ssm", "cross")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    """One transformer block position inside a repeating pattern.

    mixer: "attn" global self-attention | "local" sliding-window attention |
           "rec" RG-LRU recurrent block | "ssm" Mamba-1 block |
           "cross" self-attention followed by cross-attention (enc-dec / VLM)
    ffn:   "dense" | "moe" | "none" (mamba blocks carry their own channel mix)
    """

    mixer: str = "attn"
    ffn: str = "dense"

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class Segment:
    """``pattern`` repeated ``repeats`` times."""

    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0                  # hidden dim of the shared expert FFN
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    router_softmax: bool = True        # False -> sigmoid scoring (deepseek-v3 style)
    dispatch: str = "global"           # "global" | "per_sample" (EP-local
    # routing: sort/gather stay inside the batch shard; see §Perf)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (Griffin / RecurrentGemma)."""

    lru_width: int = 0                 # 0 -> d_model
    d_conv: int = 4
    c_exponent: float = 8.0


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder backbone (conv frontend is a stub:
    input_specs() feeds precomputed frame embeddings)."""

    num_layers: int
    num_frames: int = 1500             # 30s audio at 50 Hz after conv stack
    d_frontend: int = 0                # 0 -> d_model (stub embeddings arrive at d_model)


@dataclass(frozen=True)
class VisionConfig:
    """Llama-3.2-Vision style cross-attention to stub patch embeddings."""

    num_patches: int = 1601            # 448x448 @ patch 14 (+cls), 4 tiles collapsed
    d_patch: int = 0                   # 0 -> d_model (stub embeddings arrive at d_model)


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    window_size: int = 0               # sliding window for "local" mixers
    qk_norm: bool = False
    attn_softcap: float = 0.0          # gemma2 attention logit soft-capping
    logit_softcap: float = 0.0         # gemma2 final logit soft-capping
    rope_theta: float = 10000.0
    use_rope: bool = True
    max_position_embeddings: int = 0   # >0 -> learned absolute positions (whisper)
    # ffn
    d_ff: int = 0
    mlp_type: str = "swiglu"           # swiglu | geglu | relu2 | gelu
    # norm
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    norm_unit_offset: bool = False     # gemma-style (1 + w) RMSNorm scale
    post_norm: bool = False            # gemma2-style post-sublayer norms
    embed_scale: bool = False          # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False
    # sub-modules
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # numerics
    dtype: str = "bfloat16"
    attn_lowp_probs: bool = False      # bf16 attention scores/probs (perf
    # policy; halves the dominant HBM term of attention-heavy cells)
    remat_policy: str = "nothing"      # "nothing" | "dots" (save matmul outs)
    # provenance
    source: str = ""
    notes: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """True when no segment contains a *global* attention mixer, i.e. the
        architecture can decode at 500k context with O(window)/O(1) state."""
        for seg in self.segments:
            for spec in seg.pattern:
                if spec.mixer in ("attn", "cross"):
                    return False
        return True

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        out = []
        for seg in self.segments:
            out.extend(seg.pattern * seg.repeats)
        return tuple(out)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small: dict = dict(
            d_model=64,
            vocab_size=256,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            window_size=min(self.window_size, 16) if self.window_size else 0,
            max_position_embeddings=128 if self.max_position_embeddings else 0,
            dtype="float32",
        )
        # shrink segments: keep the pattern, cut repeats
        segs = tuple(
            Segment(s.pattern, min(s.repeats, 2)) for s in self.segments
        )
        small["segments"] = segs
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=64,
                d_shared=64 if self.moe.num_shared_experts else 0)
        if self.mla:
            small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16)
        if self.ssm:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=4, dt_rank=8)
        if self.rglru:
            small["rglru"] = dataclasses.replace(self.rglru, lru_width=64)
        if self.encoder:
            small["encoder"] = dataclasses.replace(
                self.encoder, num_layers=2, num_frames=16)
        if self.vision:
            small["vision"] = dataclasses.replace(self.vision, num_patches=16)
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# ShapeConfig — the assigned input-shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Cell skip policy (documented in DESIGN.md §9)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("full/global attention at 524k context is the "
                       "quadratic-regime artifact the shape excludes; "
                       "run only for SSM/hybrid archs")
    return True, ""
