"""Mixture-of-Experts FFN with sort-based dispatch, the PyTorch counterpart
of `repro.nn.moe`.

Routing builds integer slot assignments (a stable argsort of the chosen
experts and ``searchsorted`` for each expert's first row), tokens are
gathered into (E, C, d) capacity buffers, the experts run as one batched
SwiGLU product over E, and the results are added back at their tokens
(``index_add_``), weighted by the renormalised router weights. A token an
expert has no room for (past its capacity ``C = ceil(S k / E *
capacity_factor)``) lands in an overflow row ``E*C`` that is dropped: it
contributes zero, and the residual stream still carries it.

The top-k is a stable descending sort, so equal probabilities keep the
lower expert first, as ``lax.top_k`` does. The expert stacks are read
through `layers.real` (a quantized stack is dequantized to the model's
dtype, as the JAX package dequantizes it before the step); the router is
float32 in every model, and the shared expert's products go through
`layers.mlp_apply` (kernel K2 when quantized). The expert products are
plain ``torch.bmm``: the JAX package computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.nn import layers as L


def moe_init(generator: torch.Generator, cfg: ArchConfig, dtype, *,
             lead=(), device=None):
    """``lead`` stacks a segment's repeats."""
    m: MoEConfig = cfg.moe
    d, E, de = cfg.d_model, m.num_experts, m.d_expert
    dev = device or generator.device

    def draw(shape, std, dt):
        return L.trunc_normal(generator, shape, std, dt, dev, lead=lead)

    p = {
        "router": {"kernel": draw((d, E), 1.0 / math.sqrt(d), torch.float32)},
        "experts": {
            "wi_gate": draw((E, d, de), 1.0 / math.sqrt(d), dtype),
            "wi_up": draw((E, d, de), 1.0 / math.sqrt(d), dtype),
            "wo": draw((E, de, d), 1.0 / math.sqrt(de), dtype),
        },
    }
    if m.num_shared_experts:
        p["shared"] = L.mlp_init(generator, d, m.d_shared or m.d_expert,
                                 "swiglu", dtype, lead=lead, device=dev)
    return p


def _route(logits: torch.Tensor, m: MoEConfig):
    """logits (S,E) float32 -> (weights (S,k), ids (S,k), the Switch
    load-balance aux ``E * sum_e f_e p_e`` over the top-1 choices)."""
    probs = torch.softmax(logits, dim=-1) if m.router_softmax \
        else torch.sigmoid(logits)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :m.top_k], topi[:, :m.top_k]
    topw = topw / torch.clamp_min(topw.sum(dim=-1, keepdim=True), 1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    return topw, topi, E * torch.sum(me * ce)


def route_tokens(p, xf: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """Routing of a flat token block (S, d): the router's weights and
    expert ids (``topw``, ``topi``), ``aux``, the capacity ``C``, and for
    each (token, choice) pair in expert order its token ``st``, weight
    ``sw``, buffer row ``slot`` (``E*C`` where dropped) and ``keep``."""
    m: MoEConfig = cfg.moe
    S = xf.shape[0]
    E, k = m.num_experts, m.top_k
    C = max(1, int(math.ceil(S * k / E * m.capacity_factor)))
    logits = xf.float() @ L.real(p["router"]["kernel"], cfg.dtype).float()
    topw, topi, aux = _route(logits, m)
    dev = xf.device
    flat_e = topi.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = torch.arange(S, device=dev).repeat_interleave(k)[order]
    sw = topw.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(S * k, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    return dict(topw=topw, topi=topi, aux=aux, C=C, st=st, sw=sw,
                slot=slot, keep=keep)


def _moe_tokens(p, xf: torch.Tensor, cfg: ArchConfig):
    """Route a flat token block (S, d). Returns ((S, d), aux)."""
    S, d = xf.shape
    E = cfg.moe.num_experts
    dt = cfg.dtype
    r = route_tokens(p, xf, cfg)
    C, st, slot = r["C"], r["st"], r["slot"]
    # gather tokens into capacity buffers (the extra row swallows overflow)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[st]
    buf = buf[:E * C].reshape(E, C, d)

    ex = p["experts"]
    g = F.silu(torch.bmm(buf, L.real(ex["wi_gate"], dt)))
    u = torch.bmm(buf, L.real(ex["wi_up"], dt))
    y = torch.bmm(g * u, L.real(ex["wo"], dt)).reshape(E * C, d)

    w = (r["sw"] * r["keep"].to(r["sw"].dtype))[:, None].to(y.dtype)
    contrib = y[torch.clamp_max(slot, E * C - 1)] * w
    out = torch.zeros((S, d), dtype=xf.dtype, device=xf.device)
    out.index_add_(0, st, contrib.to(xf.dtype))
    return out, r["aux"]


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B,T,d) -> (out (B,T,d), aux scalar).

    dispatch="per_sample" routes each batch row on its own (a loop over B,
    where the JAX package vmaps) and averages the rows' aux;
    dispatch="global" routes all B*T tokens as one block."""
    m: MoEConfig = cfg.moe
    B, T, d = x.shape
    if m.dispatch == "per_sample" and B > 1:
        outs, auxes = zip(*(_moe_tokens(p, x[b], cfg) for b in range(B)))
        out, aux = torch.stack(outs), torch.stack(auxes).mean()
    else:
        out, aux = _moe_tokens(p, x.reshape(B * T, d), cfg)
        out = out.reshape(B, T, d)
    if "shared" in p:
        out = out + L.mlp_apply(p["shared"], x, "swiglu", dtype=cfg.dtype)
    return out, aux
