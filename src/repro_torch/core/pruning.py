"""Unstructured magnitude pruning (paper §II-B), in PyTorch."""
from __future__ import annotations

import torch


def magnitude_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Keep the largest-|w| (1-sparsity) fraction. Returns a bool mask; the
    threshold is the k-th largest magnitude and ties with it are kept."""
    assert 0.0 <= sparsity < 1.0
    if sparsity == 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    k = int(round(w.numel() * (1.0 - sparsity)))
    k = max(k, 1)
    thresh = torch.sort(torch.abs(w).reshape(-1)).values[-k]
    return torch.abs(w) >= thresh


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked weight with masked gradient (pruned entries stay dead)."""
    return w * mask.to(w.dtype)
