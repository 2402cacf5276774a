"""int8 gradient compression with error feedback (EF-SGD style), the
counterpart of `repro.dist.grad_compression` as plain tensor code.

Cross-host gradient all-reduce is the bandwidth bottleneck of data-parallel
training at scale; 8-bit symmetric quantization cuts the wire bytes 4x vs
fp32 (2x vs bf16). The quantization residual is carried in an error-
feedback state and re-injected next step, so the *sum over steps* of what
was transmitted tracks the sum of true gradients.

Trees are nests of dicts, tuples and lists of tensors, walked in the
reference's leaf order (`train.optimizer.tree_leaves`). `torch.round`,
like ``jnp.round``, rounds half to even, so every leaf matches the
reference bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-leaf int8 quantization. -> (q int8, scale fp32) with
    g ~= q * scale and |g - q*scale| <= scale/2 elementwise."""
    amax = torch.clamp_min(torch.max(torch.abs(g)), 1e-12)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error_state(grads):
    """Zero EF residual matching the gradient tree (float32)."""
    return tree_unflatten(grads, [torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device)
                                  for g in tree_leaves(grads)])


def compress_tree(grads, err_state):
    """One EF compression round. Returns (sent, new_err): `sent` is the
    dequantized int8 payload actually transmitted, `new_err` the residual
    to carry into the next step."""
    sent, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err_state)):
        carried = g.to(torch.float32) + e
        q, s = quantize_leaf(carried)
        out = dequantize_leaf(q, s)
        sent.append(out)
        new_err.append(carried - out)
    return tree_unflatten(grads, sent), tree_unflatten(grads, new_err)


def make_compressed_allreduce(mesh, axis_name: str, group=None):
    """-> allreduce(grads, err_state) -> (mean_grads, new_err_state).

    With a live ``torch.distributed`` process ``group`` the compressed
    payloads are averaged across its ranks (`all_reduce` of the sum, then
    divided by the group's size); without one (a single process, or
    replicated execution) the all-reduce of identical contributions is the
    identity, so the payload itself is returned. ``mesh`` is the abstract
    mesh (`dist.sharding.AbstractMesh`) that names ``axis_name``.
    """
    assert axis_name in dict(mesh.shape), (axis_name, mesh)

    def allreduce(grads, err_state):
        sent, new_err = compress_tree(grads, err_state)
        if group is None:
            return sent, new_err
        import torch.distributed as dist
        n = dist.get_world_size(group)
        leaves = tree_leaves(sent)
        for t in leaves:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return tree_unflatten(sent, [t / n for t in leaves]), new_err

    return allreduce
