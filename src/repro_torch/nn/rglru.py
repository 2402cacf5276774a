"""RG-LRU recurrent block (Griffin / RecurrentGemma), the PyTorch
counterpart of `repro.nn.rglru`.

Block = two branches from the input:
  gate branch:      W_gate -> GeLU (tanh form)
  recurrent branch: W_x -> causal depthwise conv (K=4) -> RG-LRU
output = (lru_out * gelu(gate)) @ W_out

RG-LRU recurrence (all elementwise over lru_width):
  r_t = sigmoid(x_t W_a + b_a)               recurrence gate
  i_t = sigmoid(x_t W_i + b_i)               input gate
  log a_t = -c * r_t * softplus(Lambda)      (a = sigmoid(Lambda) ^ (c r_t))
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is plain PyTorch, as it is plain jnp in the JAX package (no
Pallas kernel): a loop over time in float32, one ``addcmul`` a step.
``softplus`` is ``log(1 + exp(x))`` without PyTorch's switch to ``x``
above 20 (`torch.logaddexp`, as ``jax.nn.softplus``). The state ``h`` is
float32; the conv state has the model's dtype. Caches are written in
place. ``w_x``, ``w_gate`` and
``w_out`` go through `layers.dense_apply` (kernel K2 when quantized);
``w_a``, ``w_i``, the conv and ``Lambda`` are read through `layers.real`
and, like the JAX package's einsums, the gates are computed in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, RGLRUConfig
from repro_torch.nn import layers as L
from repro_torch.nn.ssm import _causal_conv


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_init(generator: torch.Generator, cfg: ArchConfig, dtype, *,
               lead=(), device=None):
    """``Lambda`` drawn so that a = sigmoid(Lambda) lies in [0.9, 0.999];
    ``lead`` stacks a segment's repeats."""
    r: RGLRUConfig = cfg.rglru
    w, d = _width(cfg), cfg.d_model
    lead = tuple(lead)
    dev = device or generator.device
    kw = dict(lead=lead, device=dev)
    u = 0.9 + 0.099 * L.uniform(generator, lead + (w,), dev)
    return {
        "w_x": L.dense_init(generator, d, w, dtype, **kw),
        "w_gate": L.dense_init(generator, d, w, dtype, **kw),
        "conv": {"kernel": L.trunc_normal(generator, (r.d_conv, w),
                                          1.0 / math.sqrt(r.d_conv), dtype,
                                          dev, lead=lead),
                 "bias": torch.zeros(lead + (w,), dtype=L.torch_dtype(dtype),
                                     device=dev)},
        "w_a": {"kernel": L.trunc_normal(generator, (w, w), w ** -0.5, dtype,
                                         dev, lead=lead),
                "bias": torch.zeros(lead + (w,), device=dev)},
        "w_i": {"kernel": L.trunc_normal(generator, (w, w), w ** -0.5, dtype,
                                         dev, lead=lead),
                "bias": torch.zeros(lead + (w,), device=dev)},
        "Lambda": torch.log(u) - torch.log1p(-u),
        "w_out": L.dense_init(generator, w, d, dtype, **kw),
    }


def _log_a(r_gate: torch.Tensor, lam: torch.Tensor, c: float):
    return -c * r_gate * torch.logaddexp(lam, torch.zeros_like(lam))


def _beta(log_a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))


def _rglru_scan(x, r_gate, i_gate, lam, c: float, h0):
    """x/r_gate/i_gate: (B,T,w) float32; h0 (B,w) float32. Returns y
    (B,T,w) and h_last (B,w)."""
    log_a = _log_a(r_gate, lam, c)
    # one unbind a tensor (its backward one stack), not a select a step
    # (whose backward would write a zero-filled (T, B, w) gradient a step)
    a = torch.unbind(torch.exp(log_a), dim=1)                   # T x (B,w)
    gated = torch.unbind(_beta(log_a) * (i_gate * x), dim=1)
    hs, h = [], h0
    for a_t, g_t in zip(a, gated):
        h = torch.addcmul(g_t, a_t, h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_apply(p, x: torch.Tensor, cfg: ArchConfig, *, cache=None):
    """x: (B,T,d). Returns (out, cache).

    cache (decode): {"conv": (B, K-1, w), "h": (B, w) float32}, written in
    place. One token with a cache takes one state update; anything else
    the scan, from the cache's ``h`` when there is one."""
    r: RGLRUConfig = cfg.rglru
    dt = cfg.dtype
    gate = F.gelu(L.dense_apply(p["w_gate"], x, dtype=dt), approximate="tanh")
    xb = L.dense_apply(p["w_x"], x, dtype=dt)
    xb, new_conv = _causal_conv(
        xb, L.real(p["conv"]["kernel"], dt), L.real(p["conv"]["bias"], dt),
        state=None if cache is None else cache["conv"])
    xf = xb.float()

    def gate_of(name):
        w = L.real(p[name]["kernel"], dt).float()
        return torch.sigmoid(torch.matmul(xf, w)
                             + L.real(p[name]["bias"], dt))

    r_gate, i_gate = gate_of("w_a"), gate_of("w_i")
    lam = L.real(p["Lambda"], dt)
    if cache is not None and x.shape[1] == 1:
        log_a = _log_a(r_gate[:, 0], lam, r.c_exponent)
        h = torch.exp(log_a) * cache["h"] \
            + _beta(log_a) * (i_gate[:, 0] * xf[:, 0])
        y = h[:, None]
    else:
        h0 = cache["h"] if cache is not None else \
            torch.zeros((x.shape[0], xf.shape[-1]), device=x.device)
        y, h = _rglru_scan(xf, r_gate, i_gate, lam, r.c_exponent, h0)
    if cache is not None:
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)

    out = y.to(x.dtype) * gate
    return L.dense_apply(p["w_out"], out, dtype=dt), cache


def make_rglru_cache(cfg: ArchConfig, batch: int, dtype, *, lead=(),
                     device: DeviceLike = None):
    """Cache of one RG-LRU layer (``lead`` stacks a segment's repeats) on
    ``device`` (CUDA unless ``"cpu"``)."""
    w = _width(cfg)
    lead = tuple(lead)
    device = resolve_device(device, meta=True)
    return {
        "conv": torch.zeros(lead + (batch, cfg.rglru.d_conv - 1, w),
                            dtype=L.torch_dtype(dtype), device=device),
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                         device=device),
    }
