"""The plain reference: a `ModelSpec` language model in float32, written
from the models' published descriptions as the port runs them (see
`spec.ModelSpec`), with no kernel, cache or batching of the program.

Attention is computed whole over each sequence (causal, in blocks of
heads and queries so that it fits): MLA in its published, non-absorbed
form, k and v rebuilt per head from the compressed ``c_kv``. MoE routing
is softmax, a stable top-k, the k weights renormalized; an expert takes at
most ``C`` (token, choice) pairs of a routing group, in (token, choice)
order, and the pairs past ``C`` add nothing. Which tokens form a group, and
its ``C``, is the caller's: the program routes the tokens of one call
together, so the caller names its calls' groups.

Matrix products go through `Precision`, which is float32 with TF32 off for
the reference and float8 (e4m3, one scale a tensor) for the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .spec import ModelSpec

FP8_MAX = 448.0


def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """``f32``: products in float32. ``fp8``: both operands of every
    product but the router's (weights, attention's q k^T and P v) rounded
    to float8 e4m3 under one scale a tensor (the gradient passes straight
    through), then multiplied in float32."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(name)
        self.name = name

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t
        s = torch.clamp_min(t.detach().abs().amax(), 1e-30) / FP8_MAX
        r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t.detach())

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.cast(x) @ self.cast(w)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., L, heads, r): the two halves of the last axis rotated by
    position ``pos`` (L,) at frequencies theta^(-i / (r/2))."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def swiglu(prec: Precision, x, wg, wu, wo):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wo)


def causal_attention(q, k, v, scale: float, *, grad: bool = False,
                     prec: Optional["Precision"] = None,
                     budget: int = 1 << 28) -> torch.Tensor:
    """q (L, H, dq), k (L, KV, dq), v (L, KV, dv) of one sequence ->
    (L, H, dv); each query sees the keys at or before it. Scores are made
    for blocks of heads and queries of at most ``budget`` values; with
    ``grad`` each block is recomputed in the backward pass. ``prec``
    rounds the operands of both products."""
    cast = prec.cast if prec is not None else (lambda t: t)
    L, H, _ = q.shape
    KV = k.shape[1]
    G = H // KV
    kh = k.transpose(0, 1)                 # (KV, L, dq)
    vh = v.transpose(0, 1)
    qh = q.transpose(0, 1)                 # (H, L, dq)
    hb = max(1, min(H, budget // (L * L)))
    while H % hb:
        hb -= 1
    qb = L if hb * L * L <= budget else max(1, budget // (hb * L))
    outs = []
    for h0 in range(0, H, hb):
        kv = torch.arange(h0, h0 + hb, device=q.device) // G
        kk, vv = kh[kv], vh[kv]            # (hb, L, d)
        rows = []
        for q0 in range(0, L, qb):
            q1 = min(L, q0 + qb)

            def block(qs, kk, vv, q0=q0, q1=q1):
                s = torch.einsum("hqd,hkd->hqk", cast(qs),
                                 cast(kk[:, :q1])) * scale
                i = torch.arange(q0, q1, device=qs.device)[:, None]
                j = torch.arange(q1, device=qs.device)[None, :]
                s = s.masked_fill(j > i, float("-inf"))
                return torch.einsum("hqk,hkd->hqd",
                                    cast(torch.softmax(s, -1)),
                                    cast(vv[:, :q1]))

            qs = qh[h0:h0 + hb, q0:q1]
            rows.append(checkpoint(block, qs, kk, vv, use_reentrant=False)
                        if grad else block(qs, kk, vv))
        outs.append(torch.cat(rows, 1))
    return torch.cat(outs, 0).transpose(0, 1)


Fetch = Callable[..., torch.Tensor]     # fetch(name, layer, [expert])


class Group:
    """Tokens the program routed together: their indices into the
    flattened (sequence, position) array, in the program's order, and the
    capacity ``C`` of that call."""

    def __init__(self, index: torch.Tensor, capacity: int):
        self.index, self.capacity = index, capacity


def capacity(tokens: int, spec: ModelSpec) -> int:
    """The port's capacity for a call of ``tokens`` tokens."""
    m = spec.moe
    return max(1, math.ceil(tokens * m.top_k / m.num_experts
                            * m.capacity_factor))


def route(logits: torch.Tensor, top_k: int, C: int,
          swap: Optional[torch.Tensor] = None):
    """logits (S, E) float32 of one group -> (weights (S, k), ids (S, k),
    kept (S, k) bool, probs (S, E)). ``swap`` (S,) bool: rows that take
    their (k+1)-th expert in place of their k-th (a near-tie decided the
    other way)."""
    probs = torch.softmax(logits, -1)
    sw, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    pick = torch.arange(top_k, device=probs.device).expand(
        probs.shape[0], top_k).clone()
    if swap is not None:
        pick[swap, -1] = top_k
    topw, topi = sw.gather(-1, pick), si.gather(-1, pick)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    E = logits.shape[-1]
    starts = torch.searchsorted(se, torch.arange(E, device=se.device))
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=se.device) - starts[se]
    return topw, topi, (rank < C).view_as(topi), probs


class Model:
    """The forward pass over whole sequences, layer by layer. ``fetch``
    gives float32 weights by leaf name, layer index within its group and,
    for an expert stack, the expert."""

    def __init__(self, spec: ModelSpec, fetch: Fetch,
                 prec: Optional[Precision] = None, *, grad: bool = False):
        self.s, self.fetch = spec, fetch
        self.prec = prec or Precision("f32")
        self.grad = grad
        # each MoE layer's routing margins, (p_k - p_k+1) / p_k a token:
        # how near its k-th choice came to a tie
        self.margins: List[torch.Tensor] = []
        # layer -> (n L,) bool: tokens routed with that near-tie flipped
        self.swap: Dict[int, torch.Tensor] = {}

    # -- attention --------------------------------------------------------
    def _mla(self, a, g, r, pos):
        s, P, W = self.s, self.prec, lambda n: self.fetch(f"{g}.{n}", r)
        m = s.mla
        n, L, d = a.shape
        H, nope, rp = s.num_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
        cq = rms(P.mm(a, W("w_dq")), W("q_norm"), s.rms_eps)
        q = P.mm(cq, W("w_uq").reshape(m.q_lora_rank, -1)).view(
            n, L, H, nope + rp)
        ckv = rms(P.mm(a, W("w_dkv")), W("kv_norm"), s.rms_eps)
        kr = P.mm(a, W("w_kr"))[:, :, None, :]
        k_nope = P.mm(ckv, W("w_uk").reshape(m.kv_lora_rank, -1)).view(
            n, L, H, nope)
        v = P.mm(ckv, W("w_uv").reshape(m.kv_lora_rank, -1)).view(
            n, L, H, m.v_head_dim)
        out = []
        for b in range(n):
            qb = torch.cat([q[b, :, :, :nope],
                            rope(q[b, :, :, nope:], pos, s.rope_theta)], -1)
            krb = rope(kr[b], pos, s.rope_theta).expand(L, H, rp)
            kb = torch.cat([k_nope[b], krb], -1)
            out.append(causal_attention(qb, kb, v[b], (nope + rp) ** -0.5,
                                        grad=self.grad, prec=P))
        o = torch.stack(out).reshape(n, L, H * m.v_head_dim)
        return P.mm(o, W("wo").reshape(H * m.v_head_dim, d))

    def _gqa(self, a, g, r, pos):
        s, P, W = self.s, self.prec, lambda n: self.fetch(f"{g}.{n}", r)
        n, L, d = a.shape
        H, KV, hd = s.num_heads, s.num_kv_heads, s.head_dim
        q = P.mm(a, W("wq").reshape(d, -1)).view(n, L, H, hd)
        k = P.mm(a, W("wk").reshape(d, -1)).view(n, L, KV, hd)
        v = P.mm(a, W("wv").reshape(d, -1)).view(n, L, KV, hd)
        out = [causal_attention(rope(q[b], pos, s.rope_theta),
                                rope(k[b], pos, s.rope_theta), v[b],
                                hd ** -0.5, grad=self.grad, prec=P)
               for b in range(n)]
        o = torch.stack(out).reshape(n, L, H * hd)
        return P.mm(o, W("wo").reshape(H * hd, d))

    # -- feed-forward -----------------------------------------------------
    def _dense(self, a, r):
        W = lambda n: self.fetch(f"dense.{n}", r)
        return swiglu(self.prec, a, W("ff_gate"), W("ff_up"), W("ff_out"))

    def _moe(self, a, i, r, groups: Sequence[Group]):
        """a (n, L, d) -> (out, aux): aux is the Switch load-balance term
        E * sum_e mean(probs)_e * share(top-1 = e), one per group, averaged
        over groups of equal size as the port has a single group a call."""
        s, P = self.s, self.prec
        m = s.moe
        n, L, d = a.shape
        flat = a.reshape(n * L, d)
        router = self.fetch("moe.router", r)
        toks, ids, wts, auxes = [], [], [], []
        margin = None if self.grad else \
            torch.full((n * L,), float("inf"), device=a.device)
        for grp in groups:
            x = flat[grp.index]
            flip = self.swap.get(i)
            topw, topi, kept, probs = route(
                x @ router, m.top_k, grp.capacity,
                None if flip is None else flip[grp.index])
            if margin is not None:
                top = torch.topk(probs, m.top_k + 1, -1).values
                margin[grp.index] = (top[:, -2] - top[:, -1]) / top[:, -2]
            tok = grp.index[:, None].expand_as(topi)
            toks.append(tok[kept])
            ids.append(topi[kept])
            wts.append(topw[kept])
            ce = F.one_hot(topi[:, 0], m.num_experts).float().mean(0)
            auxes.append(m.num_experts * (probs.mean(0) * ce).sum())
        if margin is not None:
            self.margins.append(margin.view(n, L))
        tok, eid, wt = torch.cat(toks), torch.cat(ids), torch.cat(wts)
        out = torch.zeros_like(flat)
        for e in torch.unique(eid).tolist():
            sel = eid == e
            te = tok[sel]
            y = swiglu(P, flat[te], self.fetch("moe.e_gate", r, e),
                       self.fetch("moe.e_up", r, e),
                       self.fetch("moe.e_out", r, e))
            out = out.index_add(0, te, y * wt[sel][:, None])
        out = out.view(n, L, d)
        if m.d_shared:
            W = lambda nm: self.fetch(f"moe.{nm}", r)
            out = out + swiglu(P, a, W("s_gate"), W("s_up"), W("s_wo"))
        return out, torch.stack(auxes).mean()

    # -- model ------------------------------------------------------------
    def layer(self, h, i: int, pos, groups):
        s = self.s
        g, r = ("dense", i) if i < s.n_dense else ("moe", i - s.n_dense)
        a = rms(h, self.fetch(f"{g}.norm1", r), s.rms_eps)
        h = h + (self._mla if s.mla else self._gqa)(a, g, r, pos)
        a = rms(h, self.fetch(f"{g}.norm2", r), s.rms_eps)
        if g == "dense":
            return h + self._dense(a, r), None
        o, aux = self._moe(a, i, r, groups)
        return h + o, aux

    def hidden(self, tokens: torch.Tensor,
               groups: Optional[Sequence[Group]] = None, *,
               start: int = 0, h: Optional[torch.Tensor] = None,
               inputs: Optional[List[torch.Tensor]] = None):
        """tokens (n, L) -> (final-normed hidden states (n, L, d), the MoE
        layers' aux summed). ``groups`` default: all n L tokens one group
        at the port's capacity for that many. ``start``, ``h``: begin at
        that layer from its input ``h``; ``inputs`` collects each layer's
        input."""
        s = self.s
        n, L = tokens.shape
        if groups is None and s.moe is not None:
            groups = [Group(torch.arange(n * L, device=tokens.device),
                            capacity(n * L, s))]
        pos = torch.arange(L, device=tokens.device)
        if h is None:
            h = self.fetch("embed")[tokens]
        aux = torch.zeros((), device=tokens.device)
        for i in range(start, s.num_layers):
            if inputs is not None:
                inputs.append(h)
            if self.grad:
                h, a = checkpoint(self.layer, h, i, pos, groups,
                                  use_reentrant=False)
            else:
                h, a = self.layer(h, i, pos, groups)
            if a is not None:
                aux = aux + a
        return rms(h, self.fetch("final_norm"), s.rms_eps), aux

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.prec.mm(h, self.fetch("lm_head"))


def next_token_loss(model: Model, h: torch.Tensor, tokens: torch.Tensor,
                    aux: torch.Tensor, *, aux_weight: float = 0.01,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy of tokens[t + 1] given position t, plus
    ``z_loss`` times the mean squared log-partition and ``aux_weight``
    times the aux; one row's logits at a time. The log-partition of the
    z term is ``log sum exp(x - stop(max x)) + max x``, so its gradient
    also reaches the largest logit through the max, as the port's loss
    (and the JAX package's) defines it."""
    n, L, _ = h.shape

    def row(hb, tb):
        lg = model.logits(hb[:-1])
        mx = lg.amax(-1, keepdim=True)
        shifted = lg - mx.detach()
        lse = torch.log(torch.exp(shifted).sum(-1, keepdim=True))
        nll = lse[:, 0] - shifted.gather(-1, tb[1:, None])[:, 0]
        z = (lse + mx)[:, 0]
        return nll.sum(), (z * z).sum()

    nll = zz = 0.0
    for b in range(n):
        a, z = checkpoint(row, h[b], tokens[b], use_reentrant=False) \
            if model.grad else row(h[b], tokens[b])
        nll, zz = nll + a, zz + z
    count = n * (L - 1)
    return nll / count + z_loss * zz / count + aux_weight * aux


def gap_of(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(-1, chosen[..., None])[..., 0]


def weight_fetch(w: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
                 bits: int, device) -> Fetch:
    """Float32 weights from the seeded tensors ``w``: a leaf with a scale
    in ``scales`` is read on that scale's integer grid (`quant.dequant`)."""
    from .quant import dequant

    def fetch(name, *index):
        t = w[name]
        for i in index:
            t = t[i]
        return dequant(t, scales.get(name), bits).to(device)
    return fetch


def scales_of(w: Dict[str, torch.Tensor],
              bits: int) -> Dict[str, torch.Tensor]:
    """The column scales of every leaf the format quantizes."""
    from .quant import column_scale, quantized
    return {k: column_scale(t, bits) for k, t in w.items()
            if quantized(t.shape)}
