"""AdamW and learning-rate schedules as plain functions on tensor trees, the
PyTorch counterpart of `repro.train.optimizer` (not `torch.optim`).

A tree is a nest of dicts, tuples and lists of tensors, walked with dict
keys in sorted order as ``jax.tree_util`` walks it, so sums over leaves
(the global norm) add in the reference's order. The moments m and v are
float32 whatever the parameters' dtype, and the parameters are updated in
their own dtype, with no float32 master copy, as in the reference.

`adamw_update` is functional: it returns new trees and leaves the old
ones alive. `adamw_update_` is the donated form, what
``jax.jit(..., donate_argnums=(0,))`` lets XLA do in the reference: it
writes the new parameters, m and v into the old tensors' storage, a
bounded slice of a leaf at a time, so neither a float32 copy of the
gradient tree nor a second state ever exists. Both make the same
roundings in the same order and give the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, sequence items
    in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """A tree of ``like``'s structure whose leaves, in `tree_leaves`
    order, are ``leaves`` (lists come back as tuples)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return tuple(build(v) for v in t)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure (lists come back as tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), float32:
    linear warmup, then cosine, linear or constant decay."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1),
                         torch.tensor(1.0, **f32))
    if cfg.schedule == "constant":
        decay = torch.tensor(1.0, **f32)
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_frac) * t
        else:  # cosine
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
                (1.0 + torch.cos(torch.tensor(math.pi, **f32) * t))
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 beside every parameter, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


def _step_terms(cfg: AdamWConfig, state: AdamWState):
    """(the new step, its learning rate, the bias corrections 1 - b1^t and
    1 - b2^t), float32 0-dim tensors beside the step."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    return step, schedule_lr(cfg, step), b1t, b2t


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"}). Weight
    decay applies to leaves of two or more dimensions; a norm scale stacked
    over a segment's repeats is one of them, as in the reference."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step, lr, b1t, b2t = _step_terms(cfg, state)

    def upd(g, m, v, p):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    triples = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        tree_leaves(params))]

    def component(i):
        return tree_unflatten(params, [t[i] for t in triples])

    return component(0), AdamWState(step, component(1), component(2)), \
        {"lr": lr, "grad_norm": gnorm}


# elements of a leaf updated at once by `adamw_update_`: its float32
# temporaries stay near 1 GiB for deepseek-v2's expert stacks (1.26 G
# elements a leaf), whose whole-leaf temporaries would be 5 GB each
UPDATE_CHUNK = 1 << 26


def adamw_update_(cfg: AdamWConfig, grads, state: AdamWState, params):
    """The donated form of `adamw_update`: the caller hands over ``params``
    and ``state``, whose m, v and parameter tensors this writes in place.
    Returns (params, new_state, metrics) as `adamw_update` does, the same
    tensors holding the same bits that it would return.

    Each gradient leaf is scaled by the clip factor inside the update,
    one flat slice of at most `UPDATE_CHUNK` elements at a time, with the
    functional form's operations in its order (``b1 * m``, ``(1 - b1) *
    g``, then their sum; no fused ``lerp_`` or ``addcmul_``, which round
    once where it rounds twice). The parameters and moments are
    contiguous, as `transformer.init`, `adamw_init` and a checkpoint's
    restore make them; a gradient need not be (the tied embedding's is a
    transpose) and is read through a contiguous copy then."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step, lr, b1t, b2t = _step_terms(cfg, state)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        decay = bool(cfg.weight_decay) and p.dim() >= 2
        flat = [t.view(-1) for t in (g.contiguous(), m, v, p)]
        for i in range(0, p.numel(), UPDATE_CHUNK):
            gs, ms, vs, ps = (t[i:i + UPDATE_CHUNK] for t in flat)
            gs = gs.to(torch.float32) * scale
            ms.mul_(cfg.b1).add_((1 - cfg.b1) * gs)
            vs.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gs))
            del gs
            delta = (ms / b1t).div_(torch.sqrt(vs / b2t).add_(cfg.eps))
            pf = ps.to(torch.float32)
            if decay:
                delta.add_(cfg.weight_decay * pf)
            ps.copy_(pf.sub_(lr * delta))
    return params, AdamWState(step, state.m, state.v), \
        {"lr": lr, "grad_norm": gnorm}
