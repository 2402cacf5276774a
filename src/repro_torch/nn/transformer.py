"""Model assembly of the LM track: blocks -> segments -> language model, the
PyTorch counterpart of `repro.nn.transformer`.

Parameters keep the JAX package's pytree as nested dictionaries and tuples:
each segment stacks the parameters of its repeating pattern along a leading
``repeats`` axis. The JAX package scans over that axis; here a Python loop
takes one repeat at a time (a view, no copy). `params_from_numpy` and
`params_to_numpy` carry the tree across as numpy arrays.

Every mixer of the JAX package is ported: "attn" and "local"
(sliding-window, with its ring buffer) attention, or MLA where the config
has one (DeepSeek-V2); "cross", a self-attention sublayer followed by a
gated cross-attention sublayer over the encoder's output or the image
patches (whisper's decoder, llama-3.2-vision's image layers); a Mamba-1
"ssm" and an RG-LRU "rec" mixer; and a dense, MoE or absent FFN. An
encoder-decoder config (whisper) adds a bidirectional encoder over stub
frame embeddings with learned positions; a vision config takes stub patch
embeddings as the cross-attention context. `forward` returns the summed
router aux loss of the MoE layers.

Public entry points:
  init(generator, cfg)                     -> params
  forward(params, batch, cfg, remat=True)  -> (logits, aux)  (train / prefill)
  decode_step(params, state, tokens, cfg)  -> (logits, state)  (one token)
  init_decode_state(cfg, batch, max_len, dtype) -> cache state
  _encoder_forward(params["encoder"], frames, cfg) -> encoder output
  active_param_count(params, cfg)          -> parameters a token uses
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as R
from repro_torch.nn import ssm as S
from repro_torch.obs import trace as TR


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _block_init(generator, cfg: ArchConfig, spec: LayerSpec, dtype, *,
                lead=(), device=None):
    kw = dict(lead=lead, device=device)
    p: Dict[str, Any] = {"norm1": L.norm_init(cfg.d_model, cfg.norm_type,
                                              **kw)}
    if spec.mixer in ("attn", "local"):
        if cfg.mla is not None:
            p["mixer"] = A.mla_init(generator, cfg, dtype, **kw)
        else:
            p["mixer"] = A.attn_init(generator, cfg, dtype, **kw)
    elif spec.mixer == "cross":
        p["mixer"] = A.attn_init(generator, cfg, dtype, cross=True, **kw)
        # tanh(0) = 0: at init the cross sublayer adds nothing
        p["cross_gate"] = torch.zeros(tuple(lead), dtype=torch.float32,
                                      device=device)
        p["norm_cross"] = L.norm_init(cfg.d_model, cfg.norm_type, **kw)
    elif spec.mixer == "ssm":
        p["mixer"] = S.ssm_init(generator, cfg, dtype, **kw)
    elif spec.mixer == "rec":
        p["mixer"] = R.rglru_init(generator, cfg, dtype, **kw)
    else:
        raise ValueError(spec.mixer)
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
                 kv_len=None, enc_out=None):
    """Returns (x, new_cache, aux); aux is the router's loss of an MoE
    FFN, else None. ``enc_out``: the cross-attention context of a "cross"
    block. The block is the span ``lm.block``, its backward pass
    ``lm.block.backward``; under remat the recompute opens ``lm.block``
    again inside the backward pass."""
    bwd = TR.backward_span("lm.block.backward", x)
    with TR.span("lm.block", mixer=spec.mixer, ffn=spec.ffn):
        x, new_cache, aux = _block_body(p, bwd.inputs(x), cfg, spec,
                                        cache=cache, kv_len=kv_len,
                                        enc_out=enc_out)
    return bwd.outputs(x), new_cache, aux


def _block_body(p, x, cfg: ArchConfig, spec: LayerSpec, *, cache, kv_len,
                enc_out):
    h = _norm(p["norm1"], x, cfg)
    if spec.mixer in ("attn", "local"):
        if cfg.mla is not None:
            o, new_cache = A.mla_apply(p["mixer"], h, cfg, cache=cache,
                                       kv_len=kv_len)
        else:
            o, new_cache = A.attn_apply(p["mixer"], h, cfg,
                                        mixer=spec.mixer, cache=cache,
                                        kv_len=kv_len)
    elif spec.mixer == "cross":
        # self-attention sublayer, then a gated cross-attention sublayer
        o, new_cache = A.attn_apply(p["mixer"], h, cfg, mixer="attn",
                                    cache=cache, kv_len=kv_len)
        if cfg.post_norm:
            o = _norm(p["post_norm1"], o, cfg)
        x = x + o
        hc = _norm(p["norm_cross"], x, cfg)
        co = A.cross_attend(p["mixer"], hc, cfg, enc_out=enc_out)
        x = x + torch.tanh(p["cross_gate"]).to(x.dtype) * co.to(x.dtype)
        o = torch.zeros_like(x)     # the residual is already applied above
    elif spec.mixer == "ssm":
        o, new_cache = S.ssm_apply(p["mixer"], h, cfg, cache=cache)
    elif spec.mixer == "rec":
        o, new_cache = R.rglru_apply(p["mixer"], h, cfg, cache=cache)
    else:
        raise ValueError(spec.mixer)
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


def _unbind(tree):
    """The repeats of a stacked tree at once, a list of trees, each leaf
    split by `torch.unbind` into views of the stack. Its backward is one
    ``stack`` of the repeats' gradients, where ``tree[r]`` for each r would
    add a zero-filled gradient of the whole stack per repeat, bytes that
    grow as the square of the depth. A quantized leaf keeps its scales:
    they are shared by every repeat (taken over the stacked weight)."""
    if L.is_qleaf(tree):
        return [{"q": q, "scale": tree["scale"]}
                for q in torch.unbind(tree["q"], 0)]
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, tuple):
        parts = [_unbind(v) for v in tree]
        return [tuple(p[r] for p in parts) for r in range(len(parts[0]))]
    return list(torch.unbind(tree, 0))


def _take(tree, r: int):
    """Repeat ``r`` of a stacked tree, as `_unbind` splits it."""
    return _unbind(tree)[r]


_BATCHLESS_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" remat policy, the JAX package's
    ``dots_with_no_batch_dims_saveable``: keep the outputs of the products
    whose einsum in the JAX package has no batch dimension, recompute
    everything else. Those products are exactly the port's ``aten.mm`` and
    ``aten.addmm``: every dense projection, the MLP's, the MoE router's,
    the RG-LRU gates' and MLA's k and v up-projections (``btc,chk->bthk``,
    computed as one ``mm``). Recomputed: every ``aten.bmm``, whatever its
    batch size, as the products over a batch dimension they compute are:
    the MoE experts' over E (``ecd,edf->ecf``), the plain attention's over
    B x H; and K5, an autograd Function, no product."""
    if op in _BATCHLESS_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _segment_apply(seg_params, x, cfg: ArchConfig, seg, *, caches=None,
                   kv_len=None, enc_out=None, remat: bool = False):
    """Returns (x, the summed aux of the MoE layers); caches are updated
    in place. ``remat``: each repeat of the pattern runs under
    `torch.utils.checkpoint.checkpoint`, which keeps only its input and
    runs it again in the backward pass, as the JAX package's
    `jax.checkpoint` of its scan body does; with ``cfg.remat_policy ==
    "dots"`` it also keeps the products `_dots_policy` names."""

    def body(x, aux, params, cache_r):
        for i, spec in enumerate(seg.pattern):
            x, _, a = _block_apply(
                params[i], x, cfg, spec,
                cache=None if cache_r is None else cache_r[i], kv_len=kv_len,
                enc_out=enc_out)
            if a is not None:
                aux = aux + a
        return x, aux

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_repeat = _unbind(seg_params)
    cache_per_repeat = None if caches is None else _unbind(caches)
    for r in range(seg.repeats):
        params = per_repeat[r]
        cache_r = None if caches is None else cache_per_repeat[r]
        if remat and cache_r is None:
            x, aux = checkpoint(body, x, aux, params, None,
                                use_reentrant=False, preserve_rng_state=False,
                                **kw)
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
    stacked leaf is drawn one repeat at a time (`layers.trunc_normal`).
    On ``device="meta"`` nothing is drawn: every leaf is an empty meta
    tensor of its shape and dtype (`launch.specs`)."""
    dev = resolve_device(device, meta=True)
    dtype = L.torch_dtype(dtype or cfg.dtype)
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
    if cfg.max_position_embeddings:
        p["pos_embed"] = L.positional_init(
            generator, cfg.max_position_embeddings, cfg.d_model, dtype, dev)
    if cfg.encoder is not None:
        # bidirectional: "attn" blocks applied without a causal mask
        seg = _encoder_segment(cfg)
        p["encoder"] = {
            "segments": (tuple(_block_init(generator, cfg, spec, dtype,
                                           lead=(seg.repeats,), device=dev)
                               for spec in seg.pattern),),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
            "pos_embed": L.positional_init(generator, cfg.encoder.num_frames,
                                           cfg.d_model, dtype, dev),
        }
    return p


def _encoder_segment(cfg: ArchConfig) -> Segment:
    return Segment((LayerSpec("attn", "dense"),), cfg.encoder.num_layers)


def _encoder_forward(p, frames, cfg: ArchConfig, *, remat: bool = True):
    """The whisper encoder over stub frame embeddings (B, F, d_model) (the
    conv frontend is a stub, as in the JAX package), cast to the model's
    dtype (the JAX package keeps the frames' dtype; ROADMAP §3), plus
    learned positions; each layer bidirectional self-attention
    (K5 with ``causal=False``) and a dense FFN; ``remat`` as in
    `forward`. Returns (B, F, d_model)."""
    dt = L.torch_dtype(cfg.dtype)
    x = frames.to(dt) + L.table_rows(p["pos_embed"], 0, frames.shape[1],
                                     dt)[None].to(dt)

    def body(x, blk):
        h = _norm(blk["norm1"], x, cfg)
        x = x + A.encoder_attn_apply(blk["mixer"], h, cfg)
        return x + L.mlp_apply(blk["mlp"], _norm(blk["norm2"], x, cfg),
                               cfg.mlp_type, dtype=cfg.dtype)

    blocks = _unbind(p["segments"][0])
    for r in range(cfg.encoder.num_layers):
        blk = blocks[r][0]
        if remat:
            x = checkpoint(body, x, blk, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, blk)
    return _norm(p["final_norm"], x, cfg)


def _embed_tokens(p, tokens, cfg: ArchConfig, offset=None):
    """Token embeddings, and learned positions where the config has them:
    from 0 at prefill, from ``offset`` (the cache length) at decode, the
    start clamped to ``max_position_embeddings - T`` as in the JAX
    package."""
    x = L.embedding_apply(p["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.max_position_embeddings:
        T = tokens.shape[1]
        start = 0 if offset is None else \
            min(offset, cfg.max_position_embeddings - T)
        x = x + L.table_rows(p["pos_embed"], start, start + T,
                             cfg.dtype)[None].to(x.dtype)
    return x


def _lm_head(p, x, cfg: ArchConfig):
    """The head's product, cast to float32 and softcapped: the span
    ``lm.head``, its backward pass ``lm.head.backward``."""
    bwd = TR.backward_span("lm.head.backward", x)
    x = bwd.inputs(x)
    with TR.span("lm.head"):
        if cfg.tie_embeddings:
            table = p["embed"]["table"]
            if L.is_qleaf(table):
                # The tied head contracts over the table's quantized axis,
                # which K2's per-output-column scales cannot express: the
                # table is dequantized and the product is one torch.matmul,
                # as the JAX package leaves this product to XLA outside any
                # Pallas kernel.
                table = L.dequantize(table, x.dtype)
            logits = torch.matmul(x, table.t())
        else:
            logits = L.dense_apply(p["lm_head"], x, dtype=cfg.dtype)
        return bwd.outputs(L.softcap(logits.float(), cfg.logit_softcap))


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True):
    """Train/prefill forward. batch: {"tokens": (B, T)}, with "frames"
    (B, F, d_model) for an encoder-decoder config (the encoder runs first)
    or "patches" (B, P, d_model) for a vision one (the cross-attention
    context as given). Returns (logits float32 (B, T, V), aux_loss: the router losses of the
    MoE layers summed, 0 without one). ``remat`` recomputes each
    block in the backward pass instead of keeping its activations (no
    effect without one); ``cfg.remat_policy == "dots"`` keeps the outputs
    of the products without batch dimensions (`_dots_policy`), the
    encoder's layers recomputed whole as in the JAX package."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = _encoder_forward(params["encoder"], batch["frames"], cfg,
                                   remat=remat)
    elif cfg.vision is not None:
        enc_out = batch["patches"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, seg in zip(params["segments"], cfg.segments):
        x, a = _segment_apply(seg_params, x, cfg, seg, enc_out=enc_out,
                              remat=remat)
        aux = aux + a
    x = _norm(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                      device: DeviceLike = None):
    """Caches stacked like the segments' parameters, the number of valid
    positions ``kv_len`` (a Python int: the host knows it), and for an
    encoder-decoder or vision config the cross-attention context
    ``enc_out``, zeros of (batch, frames or patches, d_model) in ``dtype``
    until the caller puts the encoder's output or the patches there.
    ``device="meta"`` gives the shapes alone (`launch.specs`)."""
    dev = resolve_device(device, meta=True)
    caches = tuple(tuple(_layer_cache(cfg, spec, batch, max_len, dtype,
                                      (seg.repeats,), dev)
                         for spec in seg.pattern)
                   for seg in cfg.segments)
    state = {"caches": caches, "kv_len": 0}
    context = (cfg.encoder.num_frames if cfg.encoder is not None else
               cfg.vision.num_patches if cfg.vision is not None else None)
    if context is not None:
        state["enc_out"] = torch.zeros((batch, context, cfg.d_model),
                                       dtype=L.torch_dtype(dtype), device=dev)
    return state


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                 dtype, lead, dev):
    if spec.mixer in ("attn", "local", "cross") and cfg.mla is not None:
        return A.make_mla_cache(cfg, batch, max_len, dtype, lead=lead,
                                device=dev)
    if spec.mixer == "cross":
        return A.make_attn_cache(cfg, batch, max_len, dtype, mixer="attn",
                                 lead=lead, device=dev)
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
    x = _embed_tokens(params, tokens, cfg, offset=kv_len)
    enc_out = state.get("enc_out")
    for seg_params, seg, caches in zip(params["segments"], cfg.segments,
                                       state["caches"]):
        x, _ = _segment_apply(seg_params, x, cfg, seg, caches=caches,
                              kv_len=kv_len, enc_out=enc_out)
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
    if name == "int4":      # packed two values a byte (`layers.pack_int4`)
        return L.pack_int4(torch.from_numpy(a.astype(np.int8))).to(device)
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
    bfloat16 and float8 leaves become float32. A packed 4-bit payload
    comes back as its uint8 bytes (`layers.unpack_int4` reads its
    values)."""
    def leaf(_, t):
        if isinstance(t, torch.Tensor):
            if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                t = t.float()
            return t.detach().cpu().numpy()
        return t
    return map_tree(leaf, tree)
