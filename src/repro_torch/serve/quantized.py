"""Quantized serving: the paper's minimization techniques as serving-path
weight formats, the PyTorch counterpart of `repro.serve.quantized`.

* int8 and int4 weights with per-output-channel scales: every large >=2-D
  leaf becomes ``{"q": int8, "scale": f32[last_dim]}`` (norm scales,
  biases and Mamba's ``D`` too, once stacked repeats make them large). The
  scale is taken over every axis but the last of the *stacked* leaf, so one
  scale vector serves all the repeats of a segment, as in the JAX package;
  the payload and scales match it bit for bit. PyTorch has no int4 type:
  4-bit weights are stored in int8 on the 4-bit grid [-7, 7].
* fp8 (``torch.float8_e4m3fn``) KV cache: pass that dtype to
  `transformer.init_decode_state`; cache writes cast to fp8, reads upcast.

Where the JAX package dequantizes every leaf to ``cfg.dtype`` before the
model runs, the port keeps the int8 payload: each dense product of the
decode step goes through kernel K2 (`kernels.quant_matmul`), which
dequantizes in float32 tile by tile (`nn.layers.dense_apply`). The two
steps therefore agree exactly only at ``dtype="float32"``. Every other
quantized leaf is dequantized to ``cfg.dtype`` where it is read
(`nn.layers.real`), as the JAX package dequantizes it. The embedding
gathers and dequantizes only the rows it needs; the tied LM head
dequantizes the table (see `transformer._lm_head`). RG-LRU's ``w_a`` and
``w_i``, the MoE expert stacks, MLA's ``w_uk`` and ``w_uv`` and the learned
position tables are read that way too and used in the JAX package's dtype
(`nn.rglru`, `nn.moe`, `nn.attention.mla_apply`, `layers.table_rows`):
the JAX package computes with them outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T
from repro_torch.nn.layers import is_qleaf

__all__ = ["is_qleaf", "quantize_params", "dequantize_params",
           "abstract_quantized", "make_quant_serve_step"]


def path_str(path) -> str:
    """Join a tree path into "a/b/0/c" form (`repro.dist.sharding`)."""
    return "/".join(str(k) for k in path)


def _is_quantizable(path_str: str, leaf) -> bool:
    if len(leaf.shape) < 2 or leaf.shape[-1] < 64:
        return False
    return int(np.prod(leaf.shape)) >= (1 << 16)


def _check_bits(bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(bits)


# the float32 elements one quantization step holds: a block of rows of the
# leaf viewed (-1, last dim) at a time, so a stacked leaf is never copied
# whole to float32 (falcon-mamba-7b's in_proj is 17 GB in float32; one
# repeat of deepseek-v2's expert stack, 160 x 5120 x 1536, is 5 GB)
_CHUNK_ELEMENTS = 1 << 26


def _chunks(w: torch.Tensor):
    rows = w.reshape(-1, w.shape[-1])
    return torch.split(rows, max(1, _CHUNK_ELEMENTS // rows.shape[1]), dim=0)


def quantize_params(params, bits: int = 8):
    """Real tensors -> quantized tree (per-channel symmetric). A running
    amax over blocks of rows (the leaf viewed (-1, last dim)), then the
    payload block by block: bit for bit what one pass over the whole leaf
    gives (max is exact, the rest elementwise)."""
    _check_bits(bits)
    qmax = 2.0 ** (bits - 1) - 1.0

    def leaf(path, w):
        if not _is_quantizable(path_str(path), w):
            return w
        amax = None
        for part in _chunks(w):
            m = torch.amax(torch.abs(part.float()), dim=0)
            amax = m if amax is None else torch.maximum(amax, m)
        scale = torch.clamp_min(amax, 1e-8) / qmax
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        for dst, part in zip(_chunks(q), _chunks(w)):
            dst.copy_(torch.clamp(torch.round(part.float() / scale),
                                  -qmax, qmax))
        return {"q": q, "scale": scale}

    return T.map_tree(leaf, params)


def abstract_quantized(params_shapes, bits: int = 8):
    """Tree of tensors (``device="meta"`` will do) -> the quantized tree's
    shapes and dtypes as meta tensors (shape bookkeeping; no sharding)."""
    _check_bits(bits)

    def leaf(path, w):
        if not _is_quantizable(path_str(path), w):
            return w
        return {"q": torch.empty(w.shape, dtype=torch.int8, device="meta"),
                "scale": torch.empty(w.shape[-1:], dtype=torch.float32,
                                     device="meta")}

    return T.map_tree(leaf, params_shapes)


def dequantize_params(qparams, dtype=torch.bfloat16):
    def walk(x):
        if is_qleaf(x):
            return L.dequantize(x, L.torch_dtype(dtype))
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(walk(v) for v in x)
        return x
    return walk(qparams)


def make_quant_serve_step(cfg: ArchConfig):
    """serve_step(qparams, state, tokens) -> (next_tokens (B, 1) int32,
    state): one greedy token per request on quantized weights. The logits
    of the same step are `transformer.decode_step` on ``qparams``."""

    def serve_step(qparams, state, tokens):
        logits, state = T.decode_step(qparams, state, tokens, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, state

    return serve_step
