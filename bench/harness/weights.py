"""Seeded weights of a `ModelSpec`, made on the device in a few large calls.

The benchmark makes the weights and hands the same values to the program
and to the reference. Every leaf is a view into one of two flat buffers,
one in the model's dtype and one in float32 (norm scales and the router,
which the port keeps in float32). Each buffer is filled chunk by chunk
with a standard normal truncated to [-2, 2] (drawn in float32, then cast),
and each leaf is then scaled in place by its standard deviation. The same
seed on the same kind of device gives the same bits, so the reference can
make them again after the program's state is freed.

Leaves are named as the reference reads them and stacked over the layers
of a group as the port stacks a segment's repeats: ``dense.*`` holds the
leading dense layers, ``moe.*`` the MoE layers.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from bench.reference.spec import ModelSpec

# elements drawn in float32 at a time (1 GiB)
CHUNK = 1 << 28
# small enough that an AdamW step of 1e-3 moves every bf16 weight by
# several units in its last place (so a bf16 training step without a
# float32 master copy, as the port takes, moves every leaf)
EMBED_STD = 0.02
NORM_STD = 0.02


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    std: float
    f32: bool           # in the float32 buffer, else the model's dtype


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _attn_leaves(s: ModelSpec, g: str, R: int) -> List[Leaf]:
    d, H = s.d_model, s.num_heads
    if s.mla is not None:
        m = s.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return [
            Leaf(f"{g}.w_dq", (R, d, m.q_lora_rank), d ** -0.5, False),
            Leaf(f"{g}.q_norm", (R, m.q_lora_rank), NORM_STD, True),
            Leaf(f"{g}.w_uq", (R, m.q_lora_rank, H, qk),
                 m.q_lora_rank ** -0.5, False),
            Leaf(f"{g}.w_dkv", (R, d, m.kv_lora_rank), d ** -0.5, False),
            Leaf(f"{g}.kv_norm", (R, m.kv_lora_rank), NORM_STD, True),
            Leaf(f"{g}.w_uk", (R, m.kv_lora_rank, H, m.qk_nope_head_dim),
                 m.kv_lora_rank ** -0.5, False),
            Leaf(f"{g}.w_uv", (R, m.kv_lora_rank, H, m.v_head_dim),
                 m.kv_lora_rank ** -0.5, False),
            Leaf(f"{g}.w_kr", (R, d, m.qk_rope_head_dim), d ** -0.5, False),
            Leaf(f"{g}.wo", (R, H, m.v_head_dim, d),
                 (H * m.v_head_dim) ** -0.5, False),
        ]
    KV, hd = s.num_kv_heads, s.head_dim
    return [
        Leaf(f"{g}.wq", (R, d, H, hd), d ** -0.5, False),
        Leaf(f"{g}.wk", (R, d, KV, hd), d ** -0.5, False),
        Leaf(f"{g}.wv", (R, d, KV, hd), d ** -0.5, False),
        Leaf(f"{g}.wo", (R, H, hd, d), (H * hd) ** -0.5, False),
    ]


def leaves(s: ModelSpec) -> List[Leaf]:
    """Every leaf of the model, in drawing order."""
    d = s.d_model
    out = [Leaf("embed", (s.vocab_size, d), EMBED_STD, False)]
    for g, R in (("dense", s.n_dense), ("moe", s.n_moe)):
        if not R:
            continue
        out.append(Leaf(f"{g}.norm1", (R, d), NORM_STD, True))
        out += _attn_leaves(s, g, R)
        out.append(Leaf(f"{g}.norm2", (R, d), NORM_STD, True))
        if g == "dense":
            f = s.d_ff
            out += [Leaf("dense.ff_gate", (R, d, f), d ** -0.5, False),
                    Leaf("dense.ff_up", (R, d, f), d ** -0.5, False),
                    Leaf("dense.ff_out", (R, f, d), f ** -0.5, False)]
        else:
            m = s.moe
            E, de = m.num_experts, m.d_expert
            out += [Leaf("moe.router", (R, d, E), d ** -0.5, True),
                    Leaf("moe.e_gate", (R, E, d, de), d ** -0.5, False),
                    Leaf("moe.e_up", (R, E, d, de), d ** -0.5, False),
                    Leaf("moe.e_out", (R, E, de, d), de ** -0.5, False)]
            if m.d_shared:
                ds = m.d_shared
                out += [Leaf("moe.s_gate", (R, d, ds), d ** -0.5, False),
                        Leaf("moe.s_up", (R, d, ds), d ** -0.5, False),
                        Leaf("moe.s_wo", (R, ds, d), ds ** -0.5, False)]
    out += [Leaf("final_norm", (d,), NORM_STD, True),
            Leaf("lm_head", (d, s.vocab_size), d ** -0.5, False)]
    return out


def numel(leaf: Leaf) -> int:
    return math.prod(leaf.shape)


def _fill(buf: torch.Tensor, gen: torch.Generator) -> None:
    flat = buf.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        part = flat[i:i + CHUNK]
        t = torch.empty(part.numel(), dtype=torch.float32, device=buf.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(t)
        del t


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make(s: ModelSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor, every tensor a view into one of two flat buffers
    drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    specs = leaves(s)
    dt = _DTYPES[s.dtype]
    bufs = {}
    for f32, tag in ((False, "weights"), (True, "weights.f32")):
        n = sum(numel(leaf) for leaf in specs if leaf.f32 == f32)
        buf = torch.empty(n, dtype=torch.float32 if f32 else dt,
                          device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(derive(seed, tag))
        _fill(buf, gen)
        bufs[f32] = buf
    out, offset = {}, {False: 0, True: 0}
    for leaf in specs:
        n = numel(leaf)
        o = offset[leaf.f32]
        t = bufs[leaf.f32][o:o + n].view(leaf.shape)
        t.mul_(leaf.std)
        out[leaf.name] = t
        offset[leaf.f32] = o + n
    return out


def param_count(s: ModelSpec) -> int:
    return sum(numel(leaf) for leaf in leaves(s))
