"""Model assembly of the LM track: blocks -> segments -> language model, the
PyTorch counterpart of `repro.nn.transformer`.

Parameters keep the JAX package's pytree as nested dictionaries and tuples:
each segment stacks the parameters of its repeating pattern along a leading
``repeats`` axis. The JAX package scans over that axis; here a Python loop
takes one repeat at a time (a view, no copy). `params_from_numpy` and
`params_to_numpy` carry the tree across as numpy arrays.

The port covers blocks with an "attn" or "local" (sliding-window, with
its ring buffer) attention, a Mamba-1 "ssm" or an RG-LRU "rec" mixer, and
a dense, MoE or absent FFN. `forward` returns the summed router aux loss
of the MoE layers. MLA, cross attention, the encoder and vision inputs are
later slices and raise ``NotImplementedError``.

Public entry points:
  init(generator, cfg)                     -> params
  forward(params, batch, cfg, remat=True)  -> (logits, aux)  (train / prefill)
  decode_step(params, state, tokens, cfg)  -> (logits, state)  (one token)
  init_decode_state(cfg, batch, max_len, dtype) -> cache state
  active_param_count(params, cfg)          -> parameters a token uses
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as R
from repro_torch.nn import ssm as S


def _unsupported(cfg: ArchConfig, spec: LayerSpec) -> None:
    if cfg.mla is not None:
        raise NotImplementedError("MLA is a later slice of the port")
    if cfg.encoder is not None or cfg.vision is not None:
        raise NotImplementedError("encoder and vision inputs are a later "
                                  "slice of the port")
    if spec.mixer not in ("attn", "local", "ssm", "rec"):
        raise NotImplementedError(f"the {spec.mixer!r} mixer is a later "
                                  "slice of the port")


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _block_init(generator, cfg: ArchConfig, spec: LayerSpec, dtype, *,
                lead=(), device=None):
    _unsupported(cfg, spec)
    kw = dict(lead=lead, device=device)
    p: Dict[str, Any] = {"norm1": L.norm_init(cfg.d_model, cfg.norm_type,
                                              **kw)}
    if spec.mixer == "ssm":
        p["mixer"] = S.ssm_init(generator, cfg, dtype, **kw)
    elif spec.mixer == "rec":
        p["mixer"] = R.rglru_init(generator, cfg, dtype, **kw)
    else:
        p["mixer"] = A.attn_init(generator, cfg, dtype, **kw)
    if spec.ffn == "dense":
        p["norm2"] = L.norm_init(cfg.d_model, cfg.norm_type, **kw)
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_type, dtype, **kw)
    elif spec.ffn == "moe":
        p["norm2"] = L.norm_init(cfg.d_model, cfg.norm_type, **kw)
        p["moe"] = M.moe_init(generator, cfg, dtype, **kw)
    if cfg.post_norm:
        p["post_norm1"] = L.norm_init(cfg.d_model, cfg.norm_type, **kw)
        if spec.ffn != "none":
            p["post_norm2"] = L.norm_init(cfg.d_model, cfg.norm_type, **kw)
    return p


def _norm(p, x, cfg: ArchConfig):
    return L.norm_apply(p, x, cfg.norm_type, unit_offset=cfg.norm_unit_offset,
                        dtype=cfg.dtype)


def _block_apply(p, x, cfg: ArchConfig, spec: LayerSpec, *, cache=None,
                 kv_len=None):
    """Returns (x, new_cache, aux); aux is the router's loss of an MoE
    FFN, else None."""
    _unsupported(cfg, spec)
    h = _norm(p["norm1"], x, cfg)
    if spec.mixer == "ssm":
        o, new_cache = S.ssm_apply(p["mixer"], h, cfg, cache=cache)
    elif spec.mixer == "rec":
        o, new_cache = R.rglru_apply(p["mixer"], h, cfg, cache=cache)
    else:
        o, new_cache = A.attn_apply(p["mixer"], h, cfg, mixer=spec.mixer,
                                    cache=cache, kv_len=kv_len)
    if cfg.post_norm:
        o = _norm(p["post_norm1"], o, cfg)
    x = x + o
    aux = None
    if spec.ffn != "none":
        h = _norm(p["norm2"], x, cfg)
        if spec.ffn == "moe":
            o, aux = M.moe_apply(p["moe"], h, cfg)
        else:
            o = L.mlp_apply(p["mlp"], h, cfg.mlp_type, dtype=cfg.dtype)
        if cfg.post_norm:
            o = _norm(p["post_norm2"], o, cfg)
        x = x + o
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# segments (a Python loop over repeats)
# ---------------------------------------------------------------------------


def _take(tree, r: int):
    """Repeat ``r`` of a stacked tree. A quantized leaf keeps its scales:
    they are shared by every repeat (taken over the stacked weight)."""
    if L.is_qleaf(tree):
        return {"q": tree["q"][r], "scale": tree["scale"]}
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, r) for v in tree)
    return tree[r]


def _segment_apply(seg_params, x, cfg: ArchConfig, seg, *, caches=None,
                   kv_len=None, remat: bool = False):
    """Returns (x, the summed aux of the MoE layers); caches are updated
    in place. ``remat``: each repeat of the pattern runs under
    `torch.utils.checkpoint.checkpoint`, which keeps only its input and
    runs it again in the backward pass, as the JAX package's
    `jax.checkpoint` of its scan body does."""

    def body(x, aux, params, cache_r):
        for i, spec in enumerate(seg.pattern):
            x, _, a = _block_apply(
                params[i], x, cfg, spec,
                cache=None if cache_r is None else cache_r[i], kv_len=kv_len)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(seg.repeats):
        params = _take(seg_params, r)
        cache_r = None if caches is None else _take(caches, r)
        if remat and cache_r is None:
            x, aux = checkpoint(body, x, aux, params, None,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, aux, params, cache_r)
    return x, aux


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, cfg: ArchConfig, dtype=None,
         device: DeviceLike = None):
    """Random parameters at ``cfg``'s shapes, drawn from ``generator`` on
    its own device and placed on ``device`` (CUDA unless ``"cpu"``). A
    stacked leaf is drawn one repeat at a time (`layers.trunc_normal`)."""
    dev = resolve_device(device)
    dtype = L.torch_dtype(dtype or cfg.dtype)
    if cfg.max_position_embeddings:
        raise NotImplementedError("learned positions (whisper) are a later "
                                  "slice of the port")
    p: Dict[str, Any] = {
        "embed": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, dev),
        "segments": tuple(
            tuple(_block_init(generator, cfg, spec, dtype,
                              lead=(seg.repeats,), device=dev)
                  for spec in seg.pattern)
            for seg in cfg.segments),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype, device=dev)
    return p


def _embed_tokens(p, tokens, cfg: ArchConfig):
    x = L.embedding_apply(p["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _lm_head(p, x, cfg: ArchConfig):
    if cfg.tie_embeddings:
        table = p["embed"]["table"]
        if L.is_qleaf(table):
            # The tied head contracts over the table's quantized axis, which
            # K2's per-output-column scales cannot express: the table is
            # dequantized and the product is one torch.matmul, as the JAX
            # package leaves this product to XLA outside any Pallas kernel.
            table = L.dequantize(table, x.dtype)
        logits = torch.matmul(x, table.t())
    else:
        logits = L.dense_apply(p["lm_head"], x, dtype=cfg.dtype)
    return L.softcap(logits.float(), cfg.logit_softcap)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True):
    """Train/prefill forward. batch: {"tokens": (B, T)}.
    Returns (logits float32 (B, T, V), aux_loss: the router losses of the
    MoE layers summed, 0 without one). ``remat`` recomputes each
    block in the backward pass instead of keeping its activations (no
    effect without one); the "dots" policy, which keeps the products'
    outputs, is not ported and raises."""
    if remat and cfg.remat_policy == "dots":
        raise NotImplementedError("remat_policy='dots' (keep the products' "
                                  "outputs) is not ported")
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, seg in zip(params["segments"], cfg.segments):
        x, a = _segment_apply(seg_params, x, cfg, seg, remat=remat)
        aux = aux + a
    x = _norm(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                      device: DeviceLike = None):
    """Caches stacked like the segments' parameters, and the number of
    valid positions ``kv_len`` (a Python int: the host knows it)."""
    dev = resolve_device(device)
    caches = []
    for seg in cfg.segments:
        for spec in seg.pattern:
            _unsupported(cfg, spec)
        caches.append(tuple(_layer_cache(cfg, spec, batch, max_len, dtype,
                                         (seg.repeats,), dev)
                            for spec in seg.pattern))
    return {"caches": tuple(caches), "kv_len": 0}


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                 dtype, lead, dev):
    if spec.mixer == "ssm":
        return S.make_ssm_cache(cfg, batch, dtype, lead=lead, device=dev)
    if spec.mixer == "rec":
        return R.make_rglru_cache(cfg, batch, dtype, lead=lead, device=dev)
    return A.make_attn_cache(cfg, batch, max_len, dtype, mixer=spec.mixer,
                             lead=lead, device=dev)


def decode_step(params, state, tokens, cfg: ArchConfig):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,V), new
    state); the caches of ``state`` are updated in place."""
    kv_len = state["kv_len"]
    x = _embed_tokens(params, tokens, cfg)
    for seg_params, seg, caches in zip(params["segments"], cfg.segments,
                                       state["caches"]):
        x, _ = _segment_apply(seg_params, x, cfg, seg, caches=caches,
                              kv_len=kv_len)
    x = _norm(params["final_norm"], x, cfg)
    logits = _lm_head(params, x, cfg)
    new_state = dict(state)
    new_state["kv_len"] = kv_len + tokens.shape[1]
    return logits, new_state


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    """(path, leaf) pairs of nested dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def param_count(params) -> int:
    return sum(int(x.numel()) for _, x in _leaves(params))


def active_param_count(params, cfg: ArchConfig) -> int:
    """Parameters one token uses: a routed expert's leaves count at
    top_k / E of their size (each leaf rounded down, as the JAX package
    does), everything else (a shared expert included) in full."""
    moe = cfg.moe
    return sum(int(x.numel() * moe.top_k / moe.num_experts)
               if moe is not None and "experts" in path else int(x.numel())
               for path, x in _leaves(params))


# numpy has no bfloat16 or float8 of its own: the JAX package's arrays carry
# ml_dtypes types, which cross as raw bits of the same width
_BITS_VIEW = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)         # a writable copy: the caller's stays untouched
    name = a.dtype.name
    if name in _BITS_VIEW:
        raw, tdt = _BITS_VIEW[name]
        return torch.from_numpy(a.view(raw)).view(tdt).to(device)
    if name == "int4":      # the 4-bit grid, stored in int8 (see quantized)
        a = a.astype(np.int8)
    return torch.from_numpy(a).to(device)


def map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, tuples and lists
    (lists come back as tuples), keeping the structure; ``path`` is the
    tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def params_from_numpy(tree, cfg: ArchConfig, device: DeviceLike = None):
    """The JAX package's parameter pytree as numpy arrays (nested dicts and
    tuples, segments stacked on a leading ``repeats`` axis) -> the same tree
    of tensors on ``device``, leaf dtypes kept."""
    if len(tree["segments"]) != len(cfg.segments):
        raise ValueError(f"{len(tree['segments'])} segments for "
                         f"{cfg.name}'s {len(cfg.segments)}")
    dev = resolve_device(device)
    return map_tree(lambda _, a: _to_tensor(a, dev), tree)


def params_to_numpy(tree):
    """Any tree of tensors (parameters, decode caches) -> numpy arrays;
    bfloat16 and float8 leaves become float32."""
    def leaf(_, t):
        if isinstance(t, torch.Tensor):
            if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                t = t.float()
            return t.detach().cpu().numpy()
        return t
    return map_tree(leaf, tree)
