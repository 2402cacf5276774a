"""Attention mixers of the LM track: grouped-query self-attention ("attn"
and "local", with the sliding-window ring buffer), cross attention,
the whisper encoder's bidirectional attention and DeepSeek-V2's MLA, the
PyTorch counterpart of `repro.nn.attention`.

* GQA grouping is explicit, as in the JAX package: q heads are viewed as
  (KV, G) so k and v are never repeated.
* `attend` sends every call without a cache (``q_offset == 0``, no
  ``kv_len``, no explicit key positions) through kernel K5
  (`kernels.flash_attention`), causal or not, with the window and softcap
  of the layer: every self-attention layer of a prefill forward, the
  encoder's bidirectional layers, and cross attention over the encoder's
  frames or the image patches, at prefill and at decode (one query). The
  JAX package computes these with its chunked einsum path and names the
  Pallas kernel as its TPU-native version. Where v's head_dim is smaller
  than q's (MLA: 128 against 192), v is padded with zero columns to q's
  and the output sliced back: zero columns of v give zero columns of the
  output, and the softmax scale stays q's ``1/sqrt(hd)``, so this is
  exact. A sliding-window layer without a cache takes the same kernel with
  its window, which computes exactly what the JAX package's banded path
  computes; `attend_local_banded`, that path in plain PyTorch, is the
  windowed yardstick K5 is held against and lies on no path of the model.
* Every other case (decode over the cache with ``kv_len``, or over a ring
  buffer with explicit key positions) is the JAX package's single-chunk
  path in plain PyTorch. Its chunked online-softmax scan, which only bounds
  XLA's peak memory, has no counterpart here.
* Caches are updated in place: a decode step writes this step's k and v
  into the preallocated buffers at ``kv_len``. A "local" layer whose cache
  has exactly ``window`` slots is a ring buffer: one token a step is
  written at slot ``kv_len mod window``, and slot ``j`` holds absolute
  position ``kv_len - ((kv_len - j) mod window)`` (negative, so masked,
  for a slot not written yet). As in the JAX package this is right for
  one token a step only; the JAX package's ring path gives wrong key
  positions for several (fault C6 in ROADMAP.md), and the port refuses
  them.
* MLA caches the compressed ``c_kv`` and the shared rotary key. Its
  prefill rebuilds per-head k and v and goes through K5; its decode is the
  absorbed form over the compressed cache (``w_uk`` folded into q,
  ``w_uv`` applied after the softmax), in float32 as in the JAX package,
  in plain PyTorch: the JAX package has no Pallas kernel for it.
* Cross attention projects the encoder's output (or the patches) again at
  every call, as the JAX package does; its inputs are cast to the model's
  dtype first.
* While `obs.trace.recording`, the attention core of a self-attention
  layer (after the projections, before ``wo``: the cache write and the
  attention itself) is the span ``lm.attn.attend``, MLA's
  ``lm.mla.attend``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import layers as L
from repro_torch.obs import trace as TR

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def attn_init(generator, cfg: ArchConfig, dtype, *, bias: bool = False,
              cross: bool = False, lead=(), device=None):
    """``cross`` adds the cross-attention projections ``c_wq``, ``c_wk``,
    ``c_wv`` and ``c_wo`` of a "cross" block."""
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    kw = dict(bias=bias, lead=lead, device=device)
    p = {
        "wq": L.dense_init(generator, d, H * hd, dtype, out_shape=(H, hd),
                           **kw),
        "wk": L.dense_init(generator, d, KV * hd, dtype, out_shape=(KV, hd),
                           **kw),
        "wv": L.dense_init(generator, d, KV * hd, dtype, out_shape=(KV, hd),
                           **kw),
        "wo": L.dense_in3_init(generator, H, hd, d, dtype, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.norm_init(hd, "rmsnorm", lead=lead, device=device)
        p["k_norm"] = L.norm_init(hd, "rmsnorm", lead=lead, device=device)
    if cross:
        p["c_wq"] = L.dense_init(generator, d, H * hd, dtype,
                                 out_shape=(H, hd), **kw)
        p["c_wk"] = L.dense_init(generator, d, KV * hd, dtype,
                                 out_shape=(KV, hd), **kw)
        p["c_wv"] = L.dense_init(generator, d, KV * hd, dtype,
                                 out_shape=(KV, hd), **kw)
        p["c_wo"] = L.dense_in3_init(generator, H, hd, d, dtype, **kw)
    return p


# ---------------------------------------------------------------------------
# core attend
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, scale: float, dtype=torch.float32):
    """q: (B,T,KV,G,hd)  k: (B,S,KV,hd) -> (B,KV,G,T,S)"""
    return torch.einsum("btkgh,bskh->bkgts", q.to(dtype), k.to(dtype)) \
        * scale


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int, kv_len=None):
    """(T,S) additive bias in fp32. q_pos/k_pos: integer vectors."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        ok &= k_pos[None, :] < kv_len
    return torch.where(ok, 0.0, NEG_INF)


def attend(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
           q_offset: int = 0, kv_len: Optional[int] = None,
           k_positions=None, lowp: bool = False):
    """General attention. q: (B,T,H,hd); k/v: (B,S,KV,hd) -> (B,T,H,vd),
    v's head_dim ``vd`` at most q's.

    q_offset:    absolute position of q[0] (decode: cache length).
    kv_len:      valid kv prefix length (decode with preallocated cache).
    k_positions: explicit absolute position per kv slot.
    lowp:        bf16 scores and probabilities on the plain path. K5 keeps
                 them in float32 on chip, where the policy's saving (score
                 bytes in device memory) does not arise.
    """
    if q_offset == 0 and kv_len is None and k_positions is None:
        hd, vd = q.shape[-1], v.shape[-1]
        if vd < hd:     # MLA: zero columns of v give zero columns of o
            o = flash_attention(q, k, F.pad(v, (0, hd - vd)), causal=causal,
                                window=window, softcap=softcap)
            return o[..., :vd]
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    sdt = torch.bfloat16 if lowp else torch.float32
    dev = q.device
    qg = q.reshape(B, T, KV, G, hd)
    q_pos = torch.arange(T, dtype=torch.int32, device=dev) + q_offset
    if k_positions is None:
        k_pos = torch.arange(S, dtype=torch.int32, device=dev)
        bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                          kv_len=kv_len)
    else:
        k_pos = k_positions
        ok = (k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])
        if window:
            ok &= k_pos[None, :] > q_pos[:, None] - window
        bias = torch.where(ok, 0.0, NEG_INF)
    s = L.softcap(_gqa_scores(qg, k, scale, sdt), softcap)
    s = s + bias.to(sdt)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.to(sdt))
    return o.reshape(B, T, H, vd).to(q.dtype)


def attend_local_banded(q, k, v, *, window: int, softcap: float = 0.0,
                        lowp: bool = False):
    """Exact sliding-window causal attention in O(T * 2W), the JAX
    package's banded path. q: (B,T,H,hd); k/v: (B,T,KV,hd); T need not be
    a multiple of ``window`` (padded inside). Each query block of W
    attends to key blocks i-1 and i with an in-band mask; the first block
    does not see the zero "previous" block."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    W = window
    nb = -(-T // W)
    pad = nb * W - T
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    qb = q.reshape(B, nb, W, KV, G, hd)
    kb = k.reshape(B, nb, W, KV, hd)
    vb = v.reshape(B, nb, W, KV, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                          # (B,nb,2W,KV,hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    scale = 1.0 / math.sqrt(hd)
    sdt = torch.bfloat16 if lowp else torch.float32
    s = torch.einsum("bnqkgh,bnskh->bnkgqs", qb.to(sdt), k2.to(sdt)) * scale
    s = L.softcap(s, softcap)
    dev = q.device
    q_pos = torch.arange(W, device=dev)[:, None]        # within-block q idx
    k_pos = torch.arange(2 * W, device=dev)[None, :] - W
    ok = (k_pos <= q_pos) & (k_pos > q_pos - W)
    first = torch.arange(nb, device=dev)[:, None, None] == 0
    ok = ok[None] & ~(first & (k_pos[None] < 0))         # (nb, W, 2W)
    s = s + torch.where(ok, 0.0, NEG_INF).to(sdt)[:, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnkgqs,bnskh->bnqkgh", p, v2.to(sdt))
    return o.reshape(B, nb * W, H, hd)[:, :T].to(q.dtype)


# ---------------------------------------------------------------------------
# full mixer: project -> rope -> attend -> out
# ---------------------------------------------------------------------------


def attn_apply(p, x, cfg: ArchConfig, *, mixer: str, cache=None,
               kv_len: Optional[int] = None, enc_out=None, enc_cache=None):
    """Self-attention (and, for ``mixer="cross"``, an ungated cross
    attention added to it). Returns (out, new_cache).

    cache: None (prefill, no cache) or dict(k=(B,S,KV,hd), v=...) with
    kv_len giving the number of valid entries (decode); the buffers are
    written in place and returned as the new cache. enc_out: the encoder's
    output (B, S, d) that cross attention projects, or enc_cache, its
    projected dict(k=..., v=...). The model's "cross" block calls this
    with ``mixer="attn"`` and adds its own gated cross sublayer
    (`cross_attend`); the ungated branch is the JAX package's, kept so that
    this function computes what its counterpart does.
    """
    B, T, _ = x.shape
    dt = cfg.dtype
    q = L.dense_apply(p["wq"], x, dtype=dt)     # (B,T,H,hd)
    k = L.dense_apply(p["wk"], x, dtype=dt)     # (B,T,KV,hd)
    v = L.dense_apply(p["wv"], x, dtype=dt)
    if cfg.qk_norm:
        q = L.norm_apply(p["q_norm"], q, "rmsnorm",
                         unit_offset=cfg.norm_unit_offset, dtype=dt)
        k = L.norm_apply(p["k_norm"], k, "rmsnorm",
                         unit_offset=cfg.norm_unit_offset, dtype=dt)
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[
        None, :] + (0 if kv_len is None else kv_len)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window_size if mixer == "local" else 0

    with TR.span("lm.attn.attend"):
        new_cache = None
        if cache is not None:
            S_buf = cache["k"].shape[1]
            if mixer == "local" and S_buf == cfg.window_size:
                # the ring buffer: one token a step, written at slot
                # kv_len mod window and read with each slot's absolute position
                if T != 1:
                    raise ValueError(f"a ring-buffer cache takes one token a "
                                     f"step, not {T} (the JAX package's ring "
                                     f"path mislabels the key positions of "
                                     f"several: fault C6)")
                start, valid = kv_len % S_buf, None
                j = torch.arange(S_buf, dtype=torch.int64, device=x.device)
                k_pos = kv_len - torch.remainder(kv_len - j, S_buf)
            elif kv_len + T > S_buf:
                raise ValueError(f"cache of {S_buf} slots cannot take "
                                 f"{kv_len} + {T} positions")
            else:
                start, valid, k_pos = kv_len, kv_len + T, None
            cache["k"][:, start:start + T] = k.to(cache["k"].dtype)
            cache["v"][:, start:start + T] = v.to(cache["v"].dtype)
            new_cache = cache
            o = attend(q, cache["k"], cache["v"], causal=True, window=window,
                       softcap=cfg.attn_softcap, q_offset=kv_len,
                       kv_len=valid, k_positions=k_pos,
                       lowp=cfg.attn_lowp_probs)
        else:
            o = attend(q, k, v, causal=True, window=window,
                       softcap=cfg.attn_softcap, lowp=cfg.attn_lowp_probs)
    out = L.dense_in3_apply(p["wo"], o, dtype=dt)
    if mixer == "cross":
        out = out + cross_attend(p, x, cfg, enc_out=enc_out,
                                 enc_cache=enc_cache)
    return out, new_cache


def cross_attend(p, x, cfg: ArchConfig, *, enc_out=None, enc_cache=None):
    """Non-causal attention of x's queries (``c_wq``) over the encoder's
    output projected by ``c_wk`` and ``c_wv`` (or over ``enc_cache``'s k and
    v), out through ``c_wo``: (B, T, d)."""
    dt = cfg.dtype
    cq = L.dense_apply(p["c_wq"], x, dtype=dt)
    if enc_cache is not None:
        ek, ev = enc_cache["k"], enc_cache["v"]
    elif enc_out is None:
        raise ValueError("cross attention needs the encoder's output or "
                         "the patches (enc_out), or their projections "
                         "(enc_cache)")
    else:
        enc = enc_out.to(x.dtype)
        ek = L.dense_apply(p["c_wk"], enc, dtype=dt)
        ev = L.dense_apply(p["c_wv"], enc, dtype=dt)
    co = attend(cq, ek.to(cq.dtype), ev.to(cq.dtype), causal=False)
    return L.dense_in3_apply(p["c_wo"], co, dtype=dt)


def encoder_attn_apply(p, x, cfg: ArchConfig):
    """Bidirectional self-attention (the whisper encoder): no cache, no
    rotary positions, through K5 with ``causal=False``."""
    dt = cfg.dtype
    q = L.dense_apply(p["wq"], x, dtype=dt)
    k = L.dense_apply(p["wk"], x, dtype=dt)
    v = L.dense_apply(p["wv"], x, dtype=dt)
    o = attend(q, k, v, causal=False)
    return L.dense_in3_apply(p["wo"], o, dtype=dt)


def make_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
                    mixer: str = "attn", lead=(), device=None):
    """Cache for one attention layer (``lead`` stacks a segment's repeats).
    A "local" layer gets ``min(max_len, window)`` slots, as in the JAX
    package: with ``max_len >= window`` that is the ring buffer, below it
    an ordinary cache read under the window's mask."""
    S = max_len if mixer != "local" else min(max_len, cfg.window_size)
    shape = tuple(lead) + (batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = L.torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ArchConfig, dtype, *, lead=(), device=None):
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk, qr = m.qk_nope_head_dim, m.qk_rope_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "w_dq": L.dense_init(generator, d, m.q_lora_rank, dtype, **kw),
        "q_norm": L.norm_init(m.q_lora_rank, "rmsnorm", **kw),
        "w_uq": L.dense_init(generator, m.q_lora_rank, H * (qk + qr), dtype,
                             out_shape=(H, qk + qr), **kw),
        "w_dkv": L.dense_init(generator, d, m.kv_lora_rank, dtype, **kw),
        "kv_norm": L.norm_init(m.kv_lora_rank, "rmsnorm", **kw),
        "w_uk": L.dense_init(generator, m.kv_lora_rank, H * qk, dtype,
                             out_shape=(H, qk), **kw),
        "w_uv": L.dense_init(generator, m.kv_lora_rank, H * m.v_head_dim,
                             dtype, out_shape=(H, m.v_head_dim), **kw),
        "w_kr": L.dense_init(generator, d, qr, dtype, **kw),
        "wo": L.dense_in3_init(generator, H, m.v_head_dim, d, dtype, **kw),
    }


def mla_apply(p, x, cfg: ArchConfig, *, cache=None,
              kv_len: Optional[int] = None):
    """Returns (out, new_cache); the cache is the compressed dict(c_kv=(B,
    S, kv_lora), k_rope=(B, S, qk_rope)), written in place at ``kv_len``.

    Without a cache (train, prefill) k and v are rebuilt per head from
    ``c_kv`` and attend causally through K5, q and k at head_dim qk_nope +
    qk_rope, v at v_head_dim. With a cache (decode, or a prompt of T > 1
    under the causal mask) the absorbed form runs in float32 over the
    compressed cache. ``w_uk`` and ``w_uv`` are read through `layers.real`:
    no K2 product consumes them."""
    m: MLAConfig = cfg.mla
    B, T, _ = x.shape
    H = cfg.num_heads
    qk, qr = m.qk_nope_head_dim, m.qk_rope_head_dim
    dt = cfg.dtype
    cq = L.norm_apply(p["q_norm"], L.dense_apply(p["w_dq"], x, dtype=dt),
                      "rmsnorm", dtype=dt)
    q = L.dense_apply(p["w_uq"], cq, dtype=dt)          # (B,T,H,qk+qr)
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    c_kv = L.norm_apply(p["kv_norm"], L.dense_apply(p["w_dkv"], x, dtype=dt),
                        "rmsnorm", dtype=dt)
    k_rope = L.dense_apply(p["w_kr"], x, dtype=dt)[:, :, None, :]
    offset = 0 if kv_len is None else kv_len
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[
        None, :] + offset
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    w_uk = L.real(p["w_uk"]["kernel"], dt)
    w_uv = L.real(p["w_uv"]["kernel"], dt)

    if cache is None:
        with TR.span("lm.mla.attend"):
            # btc,chk->bthk as one (B T, c) x (c, H k) product: an aten.mm,
            # which the "dots" remat policy keeps as the reference's keeps
            # this batchless einsum (torch.einsum would make it a bmm of
            # batch 1)
            k_nope = (c_kv @ w_uk.reshape(w_uk.shape[0], -1)).reshape(
                B, T, H, -1)
            v = (c_kv @ w_uv.reshape(w_uv.shape[0], -1)).reshape(
                B, T, H, -1)
            k = torch.cat([k_nope,
                           k_rope[:, :, None, :].expand(B, T, H, qr)],
                          dim=-1)
            qf = torch.cat([q_nope, q_rope], dim=-1)
            o = attend(qf, k, v, causal=True, lowp=cfg.attn_lowp_probs)
        return L.dense_in3_apply(p["wo"], o, dtype=dt), None

    S = cache["c_kv"].shape[1]
    if kv_len + T > S:
        raise ValueError(f"cache of {S} slots cannot take {kv_len} + {T} "
                         f"positions")
    with TR.span("lm.mla.attend"):
        cache["c_kv"][:, kv_len:kv_len + T] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, kv_len:kv_len + T] = k_rope.to(
            cache["k_rope"].dtype)
        ckv = cache["c_kv"].float()
        ckr = cache["k_rope"].float()
        # absorb w_uk into q: q' (B,T,H,kv_lora)
        q_abs = torch.einsum("bthk,chk->bthc", q_nope.float(), w_uk.float())
        s = (torch.einsum("bthc,bsc->bhts", q_abs, ckv)
             + torch.einsum("bthr,bsr->bhts", q_rope.float(), ckr)) \
            * (1.0 / math.sqrt(qk + qr))
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
        q_pos = torch.arange(T, dtype=torch.int32, device=x.device) + kv_len
        s = s + _mask_bias(q_pos, k_pos, causal=True, window=0,
                           kv_len=kv_len + T)
        pr = torch.softmax(s, dim=-1)
        o_c = torch.einsum("bhts,bsc->bthc", pr, ckv)
        o = torch.einsum("bthc,chk->bthk", o_c, w_uv.float())
    return L.dense_in3_apply(p["wo"], o.to(x.dtype), dtype=dt), cache


def make_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
                   lead=(), device=None):
    """The compressed cache of one MLA layer (``lead`` stacks a segment's
    repeats)."""
    m = cfg.mla
    dt = L.torch_dtype(dtype)
    lead = tuple(lead)
    return {"c_kv": torch.zeros(lead + (batch, max_len, m.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros(lead + (batch, max_len, m.qk_rope_head_dim),
                                  dtype=dt, device=device)}
