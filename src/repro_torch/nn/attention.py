"""Attention mixers of the LM track: grouped-query self-attention ("attn"
and "local", with the sliding-window ring buffer), the PyTorch counterpart
of `repro.nn.attention`.

* GQA grouping is explicit, as in the JAX package: q heads are viewed as
  (KV, G) so k and v are never repeated.
* `attend` sends self-attention over a whole sequence (no cache: causal,
  ``q_offset == 0``, no ``kv_len``, no explicit key positions) through
  kernel K5 (`kernels.flash_attention`), with the window and softcap of the
  layer; that is every layer of the prefill forward. The JAX package
  computes this case with its chunked einsum path and names the Pallas
  kernel as its TPU-native version. A sliding-window layer without a cache
  takes the same kernel with its window, which computes exactly what the
  JAX package's banded path computes; `attend_local_banded`, that path in
  plain PyTorch, is the windowed yardstick K5 is held against and lies on
  no path of the model.
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
* MLA, cross attention and the whisper encoder are later slices of the
  port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import layers as L

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def attn_init(generator, cfg: ArchConfig, dtype, *, bias: bool = False,
              lead=(), device=None):
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
    """General attention. q: (B,T,H,hd); k/v: (B,S,KV,hd) -> (B,T,H,hd).

    q_offset:    absolute position of q[0] (decode: cache length).
    kv_len:      valid kv prefix length (decode with preallocated cache).
    k_positions: explicit absolute position per kv slot.
    lowp:        bf16 scores and probabilities on the plain path. K5 keeps
                 them in float32 on chip, where the policy's saving (score
                 bytes in device memory) does not arise.
    """
    if causal and q_offset == 0 and kv_len is None and k_positions is None:
        return flash_attention(q, k, v, causal=True, window=window,
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
               kv_len: Optional[int] = None):
    """Self-attention. Returns (out, new_cache).

    cache: None (prefill, no cache) or dict(k=(B,S,KV,hd), v=...) with
    kv_len giving the number of valid entries (decode); the buffers are
    written in place and returned as the new cache.
    """
    if mixer == "cross":
        raise NotImplementedError("cross attention is a later slice of the "
                                  "port")
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
    return L.dense_in3_apply(p["wo"], o, dtype=dt), new_cache


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
