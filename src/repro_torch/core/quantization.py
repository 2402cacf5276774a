"""Quantization / precision scaling (paper §II-A), in PyTorch.

Symmetric uniform per-tensor quantizer with a straight-through estimator
for QAT, matching `repro.core.quantization` operation for operation in
float32 (``torch.round`` and ``jnp.round`` both round half to even).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Symmetric per-tensor quantizer (the only form the printed-MLP path
    uses; `repro`'s per-channel and power-of-two scales serve its LM
    track)."""
    bits: int = 8

    def __post_init__(self):
        assert 1 < self.bits <= 16, self.bits


def _scale(w: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    qmax = 2.0 ** (qc.bits - 1) - 1.0
    return torch.clamp_min(torch.amax(torch.abs(w)), 1e-8) / qmax


def quantize_int(w: torch.Tensor, qc: QuantConfig):
    """-> (q int32 in [-qmax, qmax], scale). w_hat = q * scale."""
    w = w.to(torch.float32)
    scale = _scale(w, qc)
    qmax = 2.0 ** (qc.bits - 1) - 1.0
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q.to(torch.int32), scale


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def fake_quant(w: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize with STE: forward snaps to the grid, gradient is
    identity."""
    wd = w.detach()
    q, scale = quantize_int(wd, qc)
    return w + (dequantize(q, scale, w.dtype) - wd)
