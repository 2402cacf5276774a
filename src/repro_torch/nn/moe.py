"""Mixture-of-Experts FFN with sort-based dispatch, the PyTorch counterpart
of `repro.nn.moe`.

Routing builds integer slot assignments (a stable argsort of the chosen
experts and ``searchsorted`` for each expert's first row), tokens are
gathered into (E, C, d) capacity buffers, the experts run as one batched
SwiGLU product over E, and the results, weighted by the renormalised
router weights, are put back in (token, choice) order and summed over a
token's k choices. That sum has a fixed order, so a step gives the same
bits on every run (``index_add_`` on CUDA adds with atomics, in an order
that varies from run to run; the JAX package's scatter-add adds in the
sorted order, which the port's float32 tests hold within 1e-5). A token an
expert has no room for (past its capacity ``C = ceil(S k / E *
capacity_factor)``) lands in an overflow row ``E*C`` that is dropped: it
contributes zero, and the residual stream still carries it.

The top-k is a stable descending sort, so equal probabilities keep the
lower expert first, as ``lax.top_k`` does. A bf16 or float32 expert stack
multiplies by plain ``torch.bmm`` (the JAX package computes the products
outside any Pallas kernel). A quantized stack (`serve.quantized`) is read
as stored: while the capacity C is below K2's `wgmma_min_m` for its
payload, each of the three products is one launch of K2's expert body
(`kernels.quant_matmul.quant_matmul_experts`), which applies the stack's
one scale vector after the k-sum and never makes a dequantized copy;
from that C on, the stack is dequantized to the model's dtype by
`layers.real` (as the JAX package dequantizes it before the step) and
multiplied by ``torch.bmm``. The router is float32 in every model, and
the shared expert's products go through `layers.mlp_apply` (kernel K2
when quantized).

While `obs.trace.recording`, the layer opens the spans ``lm.moe.route``,
``lm.moe.dispatch``, ``lm.moe.experts``, ``lm.moe.combine`` and
``lm.moe.shared``, and `route_tokens` counts the (token, choice) pairs
routed (``moe.pairs``, S k), the capacity rows the experts run over
(``moe.slots``, E C) and the pairs kept (``moe.pairs_kept``, a device
count read only when the counter is). While the torch profiler records,
``lm.moe.backward`` times the layer's backward pass.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.kernels.quant_matmul import quant_matmul_experts
from repro_torch.kernels.quant_matmul.ops import wgmma_min_m
from repro_torch.nn import layers as L
from repro_torch.obs import metrics as MT
from repro_torch.obs import trace as TR


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
    ``sw``, buffer row ``slot`` (``E*C`` where dropped), ``keep``, and
    ``order``, its index in (token, choice) order."""
    m: MoEConfig = cfg.moe
    S = xf.shape[0]
    E, k = m.num_experts, m.top_k
    C = max(1, int(math.ceil(S * k / E * m.capacity_factor)))
    with TR.span("lm.moe.route", S=S, E=E, k=k, C=C):
        logits = xf.float() @ L.real(p["router"]["kernel"],
                                     cfg.dtype).float()
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
    if TR.recording():
        MT.counter("moe.pairs").inc(S * k)
        MT.counter("moe.slots").inc(E * C)
        MT.counter("moe.pairs_kept").inc(keep.sum())
    return dict(topw=topw, topi=topi, aux=aux, C=C, st=st, sw=sw,
                slot=slot, keep=keep, order=order)


def _expert_product(buf: torch.Tensor, leaf, dtype) -> torch.Tensor:
    """buf (E, C, K) @ an expert stack (E, K, N): a quantized stack below
    its payload's `wgmma_min_m` rows of bf16 or float32 buf (the types K2
    takes) through K2's expert body, anything else through ``torch.bmm``
    on `layers.real`'s tensor."""
    if L.is_qleaf(leaf) and buf.dtype in (torch.float32, torch.bfloat16) \
            and buf.shape[1] < wgmma_min_m(L.is_packed(leaf["q"])):
        return quant_matmul_experts(buf, leaf["q"], leaf["scale"])
    return torch.bmm(buf, L.real(leaf, dtype))


def _moe_tokens(p, xf: torch.Tensor, cfg: ArchConfig):
    """Route a flat token block (S, d). Returns ((S, d), aux)."""
    S, d = xf.shape
    E = cfg.moe.num_experts
    dt = cfg.dtype
    r = route_tokens(p, xf, cfg)
    C, st, slot = r["C"], r["st"], r["slot"]
    with TR.span("lm.moe.dispatch"):
        # gather tokens into capacity buffers (the extra row swallows
        # overflow)
        buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
        buf[slot] = xf[st]
        buf = buf[:E * C].reshape(E, C, d)

    with TR.span("lm.moe.experts"):
        ex = p["experts"]
        g = F.silu(_expert_product(buf, ex["wi_gate"], dt))
        u = _expert_product(buf, ex["wi_up"], dt)
        y = _expert_product(g * u, ex["wo"], dt).reshape(E * C, d)

    with TR.span("lm.moe.combine"):
        w = (r["sw"] * r["keep"].to(r["sw"].dtype))[:, None].to(y.dtype)
        contrib = y[torch.clamp_max(slot, E * C - 1)] * w
        # back to (token, choice) order, then each token's k choices summed
        pairs = torch.empty_like(contrib)
        pairs[r["order"]] = contrib
        out = pairs.reshape(S, -1, d).sum(dim=1)
    return out.to(xf.dtype), r["aux"]


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B,T,d) -> (out (B,T,d), aux scalar).

    dispatch="per_sample" routes each batch row on its own (a loop over B,
    where the JAX package vmaps) and averages the rows' aux;
    dispatch="global" routes all B*T tokens as one block."""
    m: MoEConfig = cfg.moe
    B, T, d = x.shape
    bwd = TR.backward_span("lm.moe.backward", x)
    x = bwd.inputs(x)
    if m.dispatch == "per_sample" and B > 1:
        outs, auxes = zip(*(_moe_tokens(p, x[b], cfg) for b in range(B)))
        out, aux = torch.stack(outs), torch.stack(auxes).mean()
    else:
        out, aux = _moe_tokens(p, x.reshape(B * T, d), cfg)
        out = out.reshape(B, T, d)
    if "shared" in p:
        with TR.span("lm.moe.shared"):
            out = out + L.mlp_apply(p["shared"], x, "swiglu",
                                    dtype=cfg.dtype)
    return bwd.outputs(out), aux
