"""Pruning (paper §II-B), in PyTorch.

Unstructured magnitude pruning is the paper's hardware winner: bespoke
circuits delete the multiplier of every zero weight outright. The module
holds per-layer and global (cross-layer) magnitude masks, structured neuron
(column) masks, block masks of (bk, bn) tiles (the unit the block-sparse
kernel K4 skips), a cubic sparsity ramp for prune-during-training, and mask
application with a masked gradient.

Parameter trees are the port's nested dicts, tuples and lists of tensors.
Thresholds are the k-th largest value; ties with it are kept.
"""
from __future__ import annotations

from typing import Callable, List

import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``;
    lists come back as tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def _kth_largest(values: torch.Tensor, sparsity: float) -> torch.Tensor:
    k = max(int(round(values.numel() * (1.0 - sparsity))), 1)
    return torch.sort(values.reshape(-1)).values[-k]


def magnitude_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Keep the largest-|w| (1-sparsity) fraction. Returns a bool mask; the
    threshold is the k-th largest magnitude and ties with it are kept."""
    assert 0.0 <= sparsity < 1.0
    if sparsity == 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    return torch.abs(w) >= _kth_largest(torch.abs(w), sparsity)


def _prunable(w: torch.Tensor, min_size: int) -> bool:
    return w.numel() >= min_size and w.dim() >= 2


def global_magnitude_masks(params, sparsity: float, *, min_size: int = 16):
    """One global threshold across all leaves of >= ``min_size`` elements
    and >= 2 dims (Deep Compression style). Small leaves (biases, norms)
    are never pruned. Returns a tree of bool masks."""
    big = [torch.abs(w).reshape(-1) for w in _leaves(params)
           if _prunable(w, min_size)]
    thresh = _kth_largest(torch.cat(big), sparsity)
    return _map(lambda w: torch.abs(w) >= thresh if _prunable(w, min_size)
                else torch.ones_like(w, dtype=torch.bool), params)


def neuron_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Structured: prune whole output columns by L2 norm."""
    norms = torch.linalg.vector_norm(w, dim=0)
    return (norms >= _kth_largest(norms, sparsity)).expand(w.shape)


def block_mask(w: torch.Tensor, sparsity: float, block=(16, 16)) -> torch.Tensor:
    """Prune (bk, bn) tiles by Frobenius norm. ``w`` is 2-D with dims
    divisible by the block (callers pad). Returns the bool mask expanded to
    w's shape; ``full[::bk, ::bn]`` is the (K/bk, N/bn) tile mask that
    `kernels.block_sparse_matmul` takes."""
    K, N = w.shape
    bk, bn = block
    if K % bk or N % bn:
        raise ValueError(f"block_mask: {tuple(w.shape)} is not a multiple "
                         f"of the block {tuple(block)}")
    tiles = w.reshape(K // bk, bk, N // bn, bn)
    norms = torch.sqrt(torch.sum(torch.square(tiles), dim=(1, 3)))
    keep = norms >= _kth_largest(norms, sparsity)
    return keep.repeat_interleave(bk, 0).repeat_interleave(bn, 1)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked weight with masked gradient (pruned entries stay dead)."""
    return w * mask.to(w.dtype)


def apply_masks(params, masks):
    return _map(apply_mask, params, masks)


def sparsity_of(masks) -> float:
    leaves = _leaves(masks)
    tot = sum(int(m.numel()) for m in leaves)
    kept = sum(int(m.sum()) for m in leaves)
    return 1.0 - kept / max(tot, 1)


def cubic_schedule(step: int, *, begin: int, end: int, final: float,
                   initial: float = 0.0) -> float:
    """Zhu & Gupta (2017) cubic sparsity ramp for prune-during-training."""
    if step <= begin:
        return initial
    if step >= end:
        return final
    t = (step - begin) / max(end - begin, 1)
    return final + (initial - final) * (1.0 - t) ** 3
