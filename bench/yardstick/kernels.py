"""The work of the port's hand-written kernels from the shapes they serve,
written again from the shapes' needs: each input byte read once, each
output byte written once, the operations the products require. MLA's v is
counted at its own head_dim, where the port pads it for K5."""
from __future__ import annotations

from typing import List, Tuple

from bench.reference.quant import quantized
from bench.reference.spec import ModelSpec
from bench.yardstick.peaks import bound_s


def k2_products(s: ModelSpec) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """(leaf, stacked shape, K, N) of every product a decode step sends
    through K2, the int8 matmul: each dense projection whose leaf the
    format quantizes, once per layer of its group, and the LM head."""
    from bench.harness.weights import leaves
    shapes = {leaf.name: leaf.shape for leaf in leaves(s)}
    d, H = s.d_model, s.num_heads
    out = []
    for g, R in (("dense", s.n_dense), ("moe", s.n_moe)):
        if not R:
            continue
        if s.mla:
            m = s.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            prods = [("w_dq", d, m.q_lora_rank),
                     ("w_uq", m.q_lora_rank, H * qk),
                     ("w_dkv", d, m.kv_lora_rank),
                     ("w_kr", d, m.qk_rope_head_dim),
                     ("wo", H * m.v_head_dim, d)]
        else:
            kv = s.num_kv_heads * s.head_dim
            prods = [("wq", d, H * s.head_dim), ("wk", d, kv), ("wv", d, kv),
                     ("wo", H * s.head_dim, d)]
        if g == "dense":
            prods += [("ff_gate", d, s.d_ff), ("ff_up", d, s.d_ff),
                      ("ff_out", s.d_ff, d)]
        elif s.moe.d_shared:
            ds = s.moe.d_shared
            prods += [("s_gate", d, ds), ("s_up", d, ds), ("s_wo", ds, d)]
        for name, K, N in prods:
            key = f"{g}.{name}"
            if quantized(shapes[key]):
                out += [(key, shapes[key], K, N)] * R
    if quantized(shapes["lm_head"]):
        out.append(("lm_head", shapes["lm_head"], d, s.vocab_size))
    return out


def k2_step_bound_s(s: ModelSpec, M: int) -> float:
    """K2's least time over one decode step at M rows: bf16 x, int8
    payloads and float32 scales read once, bf16 y written once."""
    return sum(bound_s(2.0 * M * K * N, M * K * 2 + K * N + 4 * N + M * N * 2)
               for _, _, K, N in k2_products(s))


def _pairs(T: int) -> int:
    return T * (T + 1) // 2


def k5_forward_bound_s(s: ModelSpec, B: int, T: int) -> float:
    """K5's least time for one causal self-attention layer's forward:
    q k^T at the q/k head_dim and P v at v's, bf16 q, k, v and o."""
    H, KV = s.num_heads, s.num_kv_heads
    qk, vd = s.head_dim, s.v_head_dim
    flops = 2.0 * B * H * _pairs(T) * (qk + vd)
    nbytes = 2 * B * T * (H * qk + KV * qk + KV * vd + H * vd)
    return bound_s(flops, nbytes)


def k5_backward_bound_s(s: ModelSpec, B: int, T: int) -> float:
    """K5's backward for one causal layer: the five products S = q k^T,
    dP = do v^T, dv = P^T do, dk = dS^T q, dq = dS k; q, dq, o, do, k,
    dk, v, dv moved once in bf16 and the log-sum-exp read in float32."""
    H, KV = s.num_heads, s.num_kv_heads
    hd, vd = s.head_dim, s.v_head_dim
    flops = 2.0 * (3 * hd + 2 * vd) * B * H * _pairs(T)
    nbytes = 2 * 2 * (hd * (B * T * H + B * T * KV)
                      + vd * (B * T * H + B * T * KV)) + 4 * B * H * T
    return bound_s(flops, nbytes)
