"""The work a model needs, from its shapes alone: operations of a step and
bytes a decode step must read. These are the model's work, not what the
port happens to compute: routed experts count at top_k of them per token
(no capacity padding), attention counts the causal pairs, MLA's decode
counts its absorbed form over the compressed cache, and a prefill counts
the LM head at the one position whose logits it serves. A family may
count otherwise (``bench/yardstick/family_<model_type>.py``,
`spec.overridable`)."""
from __future__ import annotations

from bench.reference.quant import quantized
from bench.reference.spec import ModelSpec, overridable


def _attn_params(s: ModelSpec) -> int:
    d, H = s.d_model, s.num_heads
    if s.mla:
        m = s.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (d * m.q_lora_rank + m.q_lora_rank * H * qk
                + d * m.kv_lora_rank + d * m.qk_rope_head_dim
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)
    return d * H * s.head_dim * 2 + 2 * d * s.num_kv_heads * s.head_dim


def _ffn_params(s: ModelSpec, kind: str) -> int:
    d = s.d_model
    if kind == "dense":
        return 3 * d * s.d_ff
    m = s.moe
    return d * m.num_experts + m.top_k * 3 * d * m.d_expert + 3 * d * m.d_shared


@overridable("yardstick")
def body_params(s: ModelSpec) -> int:
    """Weights one token multiplies through the layers (no embedding, no
    LM head)."""
    return sum(_attn_params(s) + _ffn_params(s, k) for k in s.layer_kinds())


def _pair_flops(s: ModelSpec) -> int:
    """Operations of one (query, key) pair in all heads of one layer."""
    return 2 * s.num_heads * (s.head_dim + s.v_head_dim)


@overridable("yardstick")
def forward_flops(s: ModelSpec, L: int, lm_positions: int) -> float:
    """One causal sequence of L tokens, the LM head at ``lm_positions``."""
    pairs = L * (L + 1) // 2
    return (2.0 * body_params(s) * L
            + 2.0 * s.d_model * s.vocab_size * lm_positions
            + float(_pair_flops(s)) * pairs * s.num_layers)


@overridable("yardstick")
def train_flops(s: ModelSpec, B: int, L: int) -> float:
    """A training step: three times the forward (the backward twice)."""
    return 3.0 * B * forward_flops(s, L, L)


@overridable("yardstick")
def prefill_flops(s: ModelSpec, L: int) -> float:
    return forward_flops(s, L, 1)


@overridable("yardstick")
def decode_flops(s: ModelSpec, B: int, ctx: int) -> float:
    """One decode step of B sequences, each token attending ``ctx``
    positions (its own included)."""
    if s.mla:
        m = s.mla
        per_pos = 2 * s.num_heads * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
    else:
        per_pos = _pair_flops(s)
    return B * (2.0 * (body_params(s) + s.d_model * s.vocab_size)
                + float(per_pos) * ctx * s.num_layers)


def leaf_bytes(shape, dtype_bytes: int, bits: int) -> int:
    """Bytes of a leaf as served: on the integer grid with float32 column
    scales where the format quantizes it, else at ``dtype_bytes``."""
    n = 1
    for x in shape:
        n *= x
    if bits and quantized(shape):
        rows = n // shape[-1]
        per_row = shape[-1] if bits == 8 else (shape[-1] + 1) // 2
        return rows * per_row + 4 * shape[-1]
    return n * dtype_bytes


@overridable("yardstick")
def cache_bytes_per_pos(s: ModelSpec) -> int:
    """Cache bytes one position holds over all layers (bf16)."""
    if s.mla:
        per = s.mla.kv_lora_rank + s.mla.qk_rope_head_dim
    else:
        per = 2 * s.num_kv_heads * s.head_dim
    return 2 * per * s.num_layers


@overridable("yardstick")
def decode_bytes(s: ModelSpec, B: int, ctx: int, bits: int) -> float:
    """Bytes a decode step must read: every served weight once (the
    embedding only at the B rows gathered), the cache up to ``ctx``
    positions of each sequence, the new position written."""
    from bench.harness.weights import leaves
    total = 0
    for leaf in leaves(s):
        if leaf.name == "embed":
            per_row = leaf_bytes(leaf.shape, 2, bits) // leaf.shape[0]
            total += B * per_row
        else:
            total += leaf_bytes(leaf.shape, 4 if leaf.f32 else 2, bits)
    return float(total + B * (ctx + 1) * cache_bytes_per_pos(s))
