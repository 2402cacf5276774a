"""Primitive layers of the LM track: dense, norms, embeddings, MLPs, RoPE.

The PyTorch counterpart of `repro.nn.layers`. Parameters are plain nested
dictionaries with the JAX package's leaf names and layouts (a 3-D dense
kernel is ``(d, H, hd)``, ``dense_in3`` takes ``(H, hd, d)``), so weights
carry between the two packages unchanged. Initializers draw from an explicit
``torch.Generator`` on the generator's device.

A dense kernel may also be a quantized leaf ``{"q": ..., "scale": f32}``
(`repro_torch.serve.quantized`): `dense_apply` and `dense_in3_apply` then
run the product through kernel K2 (`kernels.quant_matmul`) on the payload
and its per-output-column scales. The payload is int8 (8-bit storage, or
an older tree's 4-bit grid) or uint8 holding two 4-bit weights a byte
(`pack_int4`); the width N of the last axis is always ``scale``'s. Any
other parameter may be a quantized leaf too (a stacked norm scale or bias
crosses the quantizer's size threshold once a segment has enough
repeats): it is read through `real`, dequantized to the model's dtype as the JAX package's
``dequantize_params`` does, which is why these functions take ``dtype``.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_matmul import quant_matmul
# the one layout of packed 4-bit payloads, beside K2's plain version
from repro_torch.kernels.quant_matmul.ref import (  # noqa: F401
    is_packed, pack_int4, packed_width, unpack_int4, weights)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype name (``cfg.dtype``) or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def dequantize(leaf, dtype) -> torch.Tensor:
    """``(q.float() * scale).to(dtype)``, as `repro.serve.quantized`; a
    packed q is unpacked first."""
    return (weights(leaf["q"], leaf["scale"]).float()
            * leaf["scale"]).to(dtype)


def real(leaf, dtype):
    """A parameter as a tensor: a quantized leaf dequantized to ``dtype``
    (the model's, ``cfg.dtype``, whatever the leaf's type was before
    quantization), anything else as it is."""
    if not is_qleaf(leaf):
        return leaf
    if dtype is None:
        raise ValueError("a quantized parameter is read in the model's "
                         "dtype, and none was given")
    return dequantize(leaf, torch_dtype(dtype))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def trunc_normal(generator: torch.Generator, shape, std: float, dtype,
                 device=None, *, lead=()) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``std``, drawn in float32
    on the generator's device and cast (the JAX package's ``_trunc_normal``;
    the two frameworks' random bits differ). ``lead`` prepends stacking
    axes whose entries are drawn one at a time, so the float32 draw never
    holds more than one repeat (falcon-mamba-7b's stacked ``in_proj`` is
    17 GB in float32). On the meta device it draws nothing."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=torch_dtype(dtype),
                      device=device or generator.device)
    if out.device.type == "meta":
        return out
    for idx in itertools.product(*(range(n) for n in lead)):
        t = torch.empty(tuple(shape), dtype=torch.float32,
                        device=generator.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out[idx] = t * std
    return out


def uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) in float32, drawn on the generator's device and moved to
    ``device``; on the meta device nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), device="meta")
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device).to(device)


def dense_init(generator, d_in: int, d_out: int, dtype, *, bias=False,
               out_shape=None, lead=(), device=None):
    """Dense kernel; ``out_shape`` reshapes the output dim (e.g. (H, hd)).
    ``lead`` prepends stacking axes (a segment's ``repeats``)."""
    shape = (d_in,) + tuple(out_shape) if out_shape else (d_in, d_out)
    p = {"kernel": trunc_normal(generator, shape, 1.0 / math.sqrt(d_in),
                                dtype, device, lead=lead)}
    if bias:
        p["bias"] = torch.zeros(tuple(lead) + shape[1:],
                                dtype=torch_dtype(dtype), device=device)
    return p


def dense_in3_init(generator, h: int, hd: int, d_out: int, dtype, *,
                   bias=False, lead=(), device=None):
    p = {"kernel": trunc_normal(generator, (h, hd, d_out),
                                1.0 / math.sqrt(h * hd), dtype, device,
                                lead=lead)}
    if bias:
        p["bias"] = torch.zeros(tuple(lead) + (d_out,),
                                dtype=torch_dtype(dtype), device=device)
    return p


def _quant_product(x: torch.Tensor, leaf, k_dim: int, n_dim: int,
                   scales: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(q viewed (K, N), per-column scales) via K2; a
    packed q is viewed (K, ceil(N / 2))."""
    lead = x.shape[:-1]
    q = leaf["q"]
    y = quant_matmul(x.reshape(-1, k_dim).contiguous(),
                     q.reshape(k_dim, packed_width(n_dim) if is_packed(q)
                               else n_dim), scales)
    return y.reshape(*lead, n_dim)


def dense_apply(p, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """``dtype`` is the model's, in which a quantized bias is read."""
    k = p["kernel"]
    if is_qleaf(k):
        q = k["q"]
        if q.dim() == 2:
            y = _quant_product(x, k, q.shape[0], k["scale"].shape[0],
                               k["scale"])
        elif q.dim() == 3:  # (d, H, hd): the per-hd scale serves every head
            # (packed along hd, which is even, so (d, H * hd / 2) is a view)
            d, H = q.shape[:2]
            hd = k["scale"].shape[0]
            y = _quant_product(x, k, d, H * hd, k["scale"].repeat(H))
            y = y.reshape(*x.shape[:-1], H, hd)
        else:
            raise ValueError(tuple(q.shape))
    elif k.dim() == 2:
        y = torch.matmul(x, k)
    elif k.dim() == 3:  # (d, H, hd)
        d, H, hd = k.shape
        y = torch.matmul(x, k.reshape(d, H * hd)).reshape(
            *x.shape[:-1], H, hd)
    else:
        raise ValueError(tuple(k.shape))
    if "bias" in p:
        y = y + real(p["bias"], dtype)
    return y


def dense_in3_apply(p, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Contract a (H, hd, d) kernel against (..., H, hd) input."""
    k = p["kernel"]
    H, hd = x.shape[-2:]
    xf = x.reshape(*x.shape[:-2], H * hd)
    if is_qleaf(k):
        d = k["scale"].shape[0]
        y = _quant_product(xf, k, H * hd, d, k["scale"])
    else:
        y = torch.matmul(xf, k.reshape(H * hd, k.shape[-1]))
    if "bias" in p:
        y = y + real(p["bias"], dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(d: int, norm_type: str = "rmsnorm", *, lead=(), device=None):
    """float32 scales, as the JAX package stores them for every model."""
    shape = tuple(lead) + (d,)
    if norm_type == "rmsnorm":
        # zero-centred scale, always applied as (1 + scale)
        return {"scale": torch.zeros(shape, device=device)}
    if norm_type == "layernorm":
        return {"scale": torch.ones(shape, device=device),
                "bias": torch.zeros(shape, device=device)}
    raise ValueError(norm_type)


def norm_apply(p, x: torch.Tensor, norm_type: str = "rmsnorm", *,
               unit_offset: bool = True, eps: float = 1e-6,
               dtype=None) -> torch.Tensor:
    """``dtype`` is the model's, in which a quantized scale or bias is
    read."""
    # unit_offset kept for API parity; rmsnorm is always (1 + scale)
    del unit_offset
    xf = x.float()
    if norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * (1.0 + real(p["scale"], dtype).float())
    elif norm_type == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * real(p["scale"], dtype).float() \
            + real(p["bias"], dtype).float()
    else:
        raise ValueError(norm_type)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embedding_init(generator, vocab: int, d: int, dtype, device=None):
    return {"table": trunc_normal(generator, (vocab, d), 1.0, dtype, device)}


def embedding_apply(p, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """A quantized table dequantizes only the gathered rows, to ``dtype``."""
    t = p["table"]
    if is_qleaf(t):
        return dequantize({"q": t["q"][tokens], "scale": t["scale"]},
                          torch_dtype(dtype))
    return t[tokens]


def positional_init(generator, max_pos: int, d: int, dtype, device=None):
    """A learned absolute-position table, truncated normal with std 0.02."""
    return {"table": trunc_normal(generator, (max_pos, d), 0.02, dtype,
                                  device)}


def table_rows(p, start: int, stop: int, dtype) -> torch.Tensor:
    """Rows ``start:stop`` of a position table; a quantized table
    dequantizes only those rows, to ``dtype``."""
    t = p["table"]
    if is_qleaf(t):
        return dequantize({"q": t["q"][start:stop], "scale": t["scale"]},
                          torch_dtype(dtype))
    return t[start:stop]


# ---------------------------------------------------------------------------
# activations / MLP variants
# ---------------------------------------------------------------------------


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def mlp_init(generator, d: int, d_ff: int, mlp_type: str, dtype, *,
             bias=False, lead=(), device=None):
    kw = dict(bias=bias, lead=lead, device=device)
    if mlp_type in ("swiglu", "geglu"):
        return {"wi_gate": dense_init(generator, d, d_ff, dtype, **kw),
                "wi_up": dense_init(generator, d, d_ff, dtype, **kw),
                "wo": dense_init(generator, d_ff, d, dtype, **kw)}
    if mlp_type in ("relu2", "gelu"):
        return {"wi": dense_init(generator, d, d_ff, dtype, **kw),
                "wo": dense_init(generator, d_ff, d, dtype, **kw)}
    raise ValueError(mlp_type)


def mlp_apply(p, x: torch.Tensor, mlp_type: str, *,
              dtype=None) -> torch.Tensor:
    def dense(name, v):
        return dense_apply(p[name], v, dtype=dtype)

    if mlp_type == "swiglu":
        return dense("wo", F.silu(dense("wi_gate", x)) * dense("wi_up", x))
    if mlp_type == "geglu":
        return dense("wo", F.gelu(dense("wi_gate", x), approximate="tanh")
                     * dense("wi_up", x))
    if mlp_type == "relu2":
        return dense("wo", squared_relu(dense("wi", x)))
    if mlp_type == "gelu":
        return dense("wo", F.gelu(dense("wi", x), approximate="tanh"))
    raise ValueError(mlp_type)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions broadcastable to (..., T). Computed in
    float32 and cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., T, hd/2)
    sin = torch.sin(angles)[..., None, :]                   # (..., T, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x
