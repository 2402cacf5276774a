"""The per-column symmetric integer rule of the served weight formats,
written again for the reference.

A leaf of two or more axes whose last axis holds at least 64 columns and
which holds at least 2**16 values in all is stored as integers on
[-qmax, qmax] with one float32 scale per column of its last axis. The
scale is taken over every other axis of the leaf as it is stacked over a
group's layers, so one scale serves every layer of the group:
``scale = max(amax, 1e-8) / qmax``, ``q = clamp(round(w / scale))``.
qmax is 127 for 8 bits and 7 for 4 bits."""
from __future__ import annotations

import math
from typing import Optional

import torch

QMAX = {8: 127.0, 4: 7.0}


def quantized(shape) -> bool:
    shape = tuple(shape)
    return len(shape) >= 2 and shape[-1] >= 64 and math.prod(shape) >= 1 << 16


def column_scale(w: torch.Tensor, bits: int,
                 rows: int = 1 << 24) -> torch.Tensor:
    """The float32 scales of a stacked leaf, over blocks of rows."""
    flat = w.reshape(-1, w.shape[-1])
    amax = torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device)
    step = max(1, rows // w.shape[-1])
    for i in range(0, flat.shape[0], step):
        amax = torch.maximum(amax, flat[i:i + step].float().abs().amax(0))
    return torch.clamp_min(amax, 1e-8) / QMAX[bits]


def dequant(w: torch.Tensor, scale: Optional[torch.Tensor],
            bits: int) -> torch.Tensor:
    """``w`` (any slice of a stacked leaf, last axis whole) on the integer
    grid of ``scale`` and back, in float32; ``w`` itself in float32 where
    ``scale`` is None (a leaf the format keeps as it is)."""
    wf = w.float()
    if scale is None:
        return wf
    q = QMAX[bits]
    return torch.clamp(torch.round(wf / scale), -q, q) * scale
