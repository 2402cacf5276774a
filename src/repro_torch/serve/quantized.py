"""Quantized serving: the paper's minimization techniques as serving-path
weight formats, the PyTorch counterpart of `repro.serve.quantized`.

* int8 and int4 weights with per-output-channel scales: every large >=2-D
  leaf becomes ``{"q": payload, "scale": f32[last_dim]}`` (norm scales,
  biases and Mamba's ``D`` too, once stacked repeats make them large). The
  scale is taken over every axis but the last of the *stacked* leaf, so one
  scale vector serves all the repeats of a segment, as in the JAX package;
  the payload's values and the scales match it bit for bit. An 8-bit
  payload is int8. A 4-bit one is stored as the JAX package's ``jnp.int4``
  is, at half a byte a weight: uint8 of last axis ceil(N / 2), two values
  on [-7, 7] a byte (`nn.layers.pack_int4` has the layout; PyTorch's
  ``torch.int4`` has no kernels behind indexing or copies). An int8
  payload on the 4-bit grid, as trees written before packing hold, is
  still read as 8-bit storage.
* fp8 (``torch.float8_e4m3fn``) KV cache: pass that dtype to
  `transformer.init_decode_state`; cache writes cast to fp8, reads upcast.

Where the JAX package dequantizes every leaf to ``cfg.dtype`` before the
model runs, the port keeps the payload: each dense product of the decode
step goes through kernel K2 (`kernels.quant_matmul`), which dequantizes
in float32 tile by tile, packed 4-bit payloads in a body of their own
(`nn.layers.dense_apply`). The two steps therefore agree exactly only at
``dtype="float32"``. Every other quantized leaf is dequantized to
``cfg.dtype`` where it is read (`nn.layers.real`), as the JAX package
dequantizes it. The embedding gathers and dequantizes only the rows it
needs; the tied LM head
dequantizes the table (see `transformer._lm_head`). RG-LRU's ``w_a`` and
``w_i``, MLA's ``w_uk`` and ``w_uv`` and the learned position tables are
read that way too and used in the JAX package's dtype (`nn.rglru`,
`nn.attention.mla_apply`, `layers.table_rows`): the JAX package computes
with them outside any Pallas kernel. The MoE expert stacks are read as
stored: their products go through K2's expert body, one launch a product
over every expert, while the capacity C is below K2's `wgmma_min_m` (a
decode step's few rows an expert); a larger C dequantizes them as above
(`nn.moe`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import P, param_specs, path_str
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T
from repro_torch.nn.layers import is_qleaf

__all__ = ["is_qleaf", "quantize_params", "dequantize_params",
           "abstract_quantized", "make_quant_serve_step",
           "quantized_shardings"]


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


def _chunks(w: torch.Tensor, rows_per: int):
    """``w`` viewed (-1, last dim), split into blocks of ``rows_per`` rows."""
    return torch.split(w.reshape(-1, w.shape[-1]), rows_per, dim=0)


def _payload_shape(shape, bits: int):
    """The payload's shape: the leaf's, its last axis halved (rounded up)
    for 4 bits, two values a byte."""
    shape = tuple(shape)
    return shape[:-1] + (L.packed_width(shape[-1]),) if bits == 4 else shape


def _payload_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits == 4 else torch.int8


def quantize_params(params, bits: int = 8):
    """Real tensors -> quantized tree (per-channel symmetric). A running
    amax over blocks of rows (the leaf viewed (-1, last dim)), then the
    payload block by block: bit for bit what one pass over the whole leaf
    gives (max is exact, the rest elementwise). At 4 bits each block is
    packed two values a byte as it is written, so no int8 copy of the whole
    leaf is made."""
    _check_bits(bits)
    qmax = 2.0 ** (bits - 1) - 1.0

    def leaf(path, w):
        if not _is_quantizable(path_str(path), w):
            return w
        rows = max(1, _CHUNK_ELEMENTS // w.shape[-1])
        amax = None
        for part in _chunks(w, rows):
            m = torch.amax(torch.abs(part.float()), dim=0)
            amax = m if amax is None else torch.maximum(amax, m)
        scale = torch.clamp_min(amax, 1e-8) / qmax
        q = torch.empty(_payload_shape(w.shape, bits),
                        dtype=_payload_dtype(bits), device=w.device)
        for dst, part in zip(_chunks(q, rows), _chunks(w, rows)):
            block = torch.clamp(torch.round(part.float() / scale),
                                -qmax, qmax)
            dst.copy_(L.pack_int4(block) if bits == 4 else block)
        return {"q": q, "scale": scale}

    return T.map_tree(leaf, params)


def abstract_quantized(params_shapes, bits: int = 8):
    """Tree of tensors (``device="meta"`` will do) -> the quantized tree's
    shapes and dtypes as meta tensors (shape bookkeeping; no sharding):
    int8 payloads at 8 bits, packed uint8 ones at 4."""
    _check_bits(bits)

    def leaf(path, w):
        if not _is_quantizable(path_str(path), w):
            return w
        return {"q": torch.empty(_payload_shape(w.shape, bits),
                                 dtype=_payload_dtype(bits), device="meta"),
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


def quantized_shardings(cfg: ArchConfig, mesh, params_shapes, bits: int = 8,
                        fsdp: bool = True):
    """(spec tree, quantized shapes): q inherits the original weight's
    spec, scale replicates. ``fsdp=False`` drops the data-axis weight
    sharding (TP-only serving). The reference passes ``fsdp_enabled=`` to
    a `param_specs` that does not take it and raises (fault C7); this is
    what it means, `dist.sharding.param_specs(..., fsdp=fsdp)`. Specs are
    `dist.sharding.P` (`dist.sharding.placements` turns one into a
    DTensor's placements). A packed 4-bit payload whose last axis is
    sharded must split its bytes evenly: where ceil(N / 2) is no multiple
    of the axis' mesh size, this raises and names the leaf."""
    del cfg                     # for call-site symmetry with the reference
    specs = param_specs(params_shapes, mesh, fsdp=fsdp)
    qshapes = abstract_quantized(params_shapes, bits)
    sizes = dict(mesh.shape)

    def shards(entry) -> int:
        names = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        return int(np.prod([sizes[n] for n in names]))

    def merge(spec, q_leaf, path):
        if is_qleaf(q_leaf):
            q = q_leaf["q"]
            if L.is_packed(q) and len(spec) == q.dim():
                n = shards(spec[-1])
                if q.shape[-1] % n:
                    raise ValueError(
                        f"{path_str(path)}: the packed 4-bit payload's "
                        f"{q.shape[-1]} bytes a row do not split over "
                        f"{spec[-1]!r} ({n} shards)")
            return {"q": spec, "scale": P()}
        if isinstance(q_leaf, dict):
            return {k: merge(spec[k], q_leaf[k], path + (k,))
                    for k in q_leaf}
        if isinstance(q_leaf, tuple):
            return tuple(merge(s, q, path + (i,))
                         for i, (s, q) in enumerate(zip(spec, q_leaf)))
        return spec

    return merge(specs, qshapes, ()), qshapes
