"""Mamba-1 selective SSM block (falcon-mamba-7b), the PyTorch counterpart
of `repro.nn.ssm`.

Parameters keep the JAX package's leaves and layouts: ``conv/kernel`` is
(K, d_inner), ``dt_proj/kernel`` (dt_rank, d_inner); ``A_log``, ``D`` and
``dt_proj`` are float32 in every model. `ssm_apply` computes the scan in
one of three ways:

* no cache (the prefill forward): kernel K6 (`kernels.ssm_scan`), which
  writes y only, as the TPU kernel does;
* a cache and one token (decode): the one-step state update, plain
  PyTorch as it is plain jnp in the JAX package;
* a cache and several tokens: the plain `selective_scan`, which also
  returns the last state. It starts from the cache's state; the JAX
  package starts from zeros there (fault C3 in ROADMAP.md), which agrees
  with it for a fresh cache.

Caches are updated in place, as the attention caches are. Any parameter
may be a quantized leaf (`nn.layers.real`): the three dense products then
run through kernel K2, ``dt_proj`` on its float32 input as the JAX
package's einsum takes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels.ssm_scan import selective_scan, ssm_scan
from repro_torch.nn import layers as L


def _dims(cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return s, d_inner, dt_rank


def ssm_init(generator: torch.Generator, cfg: ArchConfig, dtype, *,
             lead=(), device=None):
    """S4D-real ``A``, ``dt`` initialised in [1e-3, 1e-1] through the
    inverse softplus of its bias; ``lead`` stacks a segment's repeats."""
    s, d_inner, dt_rank = _dims(cfg)
    d = cfg.d_model
    lead = tuple(lead)
    dev = device or generator.device
    f32 = torch.float32
    a = torch.arange(1, s.d_state + 1, dtype=f32, device=dev).expand(
        lead + (d_inner, s.d_state))
    r = L.uniform(generator, lead + (d_inner,), dev)
    dt_init = torch.exp(r * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    return {
        "in_proj": L.dense_init(generator, d, 2 * d_inner, dtype, lead=lead,
                                device=dev),
        "conv": {"kernel": L.trunc_normal(generator, (s.d_conv, d_inner),
                                          1.0 / math.sqrt(s.d_conv), dtype,
                                          dev, lead=lead),
                 "bias": torch.zeros(lead + (d_inner,),
                                     dtype=L.torch_dtype(dtype), device=dev)},
        "x_proj": L.dense_init(generator, d_inner, dt_rank + 2 * s.d_state,
                               dtype, lead=lead, device=dev),
        "dt_proj": {"kernel": L.trunc_normal(generator, (dt_rank, d_inner),
                                             dt_rank ** -0.5, f32, dev,
                                             lead=lead),
                    "bias": dt_init + torch.log(-torch.expm1(-dt_init))},
        "A_log": torch.log(a),
        "D": torch.ones(lead + (d_inner,), dtype=f32, device=dev),
        "out_proj": L.dense_init(generator, d_inner, d, dtype, lead=lead,
                                 device=dev),
    }


def _causal_conv(xc: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 *, state=None):
    """Depthwise causal conv in the JAX package's layout: xc (B, T, C),
    kernel (K, C), state (B, K-1, C) or None. A cross-correlation over time
    padded on the left by K-1 (by the state when there is one). Returns
    (y (B, T, C) contiguous, new state or None)."""
    K, C = kernel.shape
    new_state = None
    if state is not None:
        xc = torch.cat([state.to(xc.dtype), xc], dim=1)
        new_state = xc[:, xc.shape[1] - (K - 1):]
        pad = 0
    else:
        pad = K - 1
    x = F.pad(xc.transpose(1, 2), (pad, 0))            # (B, C, K-1+T)
    y = F.conv1d(x, kernel.t().unsqueeze(1), groups=C)  # weight (C, 1, K)
    return (y.transpose(1, 2) + bias).contiguous(), new_state


def ssm_apply(p, x: torch.Tensor, cfg: ArchConfig, *, cache=None):
    """Mamba-1 block. x: (B, T, d_model). Returns (out, cache).

    cache (decode): {"conv": (B, K-1, d_inner), "h": (B, d_inner, N) f32},
    written in place."""
    s, d_inner, dt_rank = _dims(cfg)
    N = s.d_state
    dtype = cfg.dtype
    xz = L.dense_apply(p["in_proj"], x, dtype=dtype)
    xc, z = xz[..., :d_inner], xz[..., d_inner:]

    xc, new_conv = _causal_conv(
        xc, L.real(p["conv"]["kernel"], dtype),
        L.real(p["conv"]["bias"], dtype),
        state=None if cache is None else cache["conv"])
    xc = F.silu(xc)

    proj = L.dense_apply(p["x_proj"], xc, dtype=dtype)
    dt_raw = proj[..., :dt_rank]
    B_ = proj[..., dt_rank:dt_rank + N]
    C_ = proj[..., dt_rank + N:]
    dt = F.softplus(
        L.dense_apply({"kernel": p["dt_proj"]["kernel"]}, dt_raw.float())
        + L.real(p["dt_proj"]["bias"], dtype))
    A = -torch.exp(L.real(p["A_log"], dtype))
    D = L.real(p["D"], dtype)

    if cache is None:
        y = ssm_scan(xc, dt, B_.contiguous(), C_.contiguous(), A.float(),
                     D.float())
    elif x.shape[1] == 1:
        # one-token decode: one state update, no scan
        u = xc[:, 0].float()
        da = torch.exp(dt[:, 0, :, None] * A[None])
        h = da * cache["h"] + (dt[:, 0] * u)[..., None] \
            * B_[:, 0, None, :].float()
        y = torch.einsum("bdn,bn->bd", h, C_[:, 0].float()) + D[None] * u
        y = y[:, None]
        cache["h"].copy_(h)
    else:
        y, h = selective_scan(xc, dt, B_, C_, A, D, h0=cache["h"])
        cache["h"].copy_(h)
    if cache is not None:
        cache["conv"].copy_(new_conv)

    y = y.to(x.dtype) * F.silu(z)
    return L.dense_apply(p["out_proj"], y, dtype=dtype), cache


def make_ssm_cache(cfg: ArchConfig, batch: int, dtype, *, lead=(),
                   device: DeviceLike = None):
    """Cache of one Mamba layer (``lead`` stacks a segment's repeats) on
    ``device`` (CUDA unless ``"cpu"``): the conv's last K-1 inputs in
    ``dtype`` and the float32 state."""
    s, d_inner, _ = _dims(cfg)
    lead = tuple(lead)
    device = resolve_device(device, meta=True)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, d_inner),
                            dtype=L.torch_dtype(dtype), device=device),
        "h": torch.zeros(lead + (batch, d_inner, s.d_state),
                         dtype=torch.float32, device=device),
    }
