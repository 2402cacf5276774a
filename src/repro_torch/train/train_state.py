"""Train state and the train, serve and prefill steps, the PyTorch
counterpart of `repro.train.train_state`.

The train step runs the model forward and backward with autograd: on a
CUDA device every attention layer's forward and backward run through
kernel K5 and its backward kernel, every Mamba layer's through K6 and its
backward kernel. The caller hands the step its state, as the reference's
dry run donates it to ``jax.jit``: the step writes the new parameters and
moments into the old state's tensors (`optimizer.adamw_update_`, the bits
of the functional `optimizer.adamw_update`), so 12 bytes a bf16 parameter
stay resident through the update instead of about 28.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.nn import transformer as T
from repro_torch.train import losses
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update_, tree_leaves,
                                         tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_state(generator: torch.Generator, cfg: ArchConfig,
               opt_cfg: AdamWConfig, device: DeviceLike = None) -> TrainState:
    """Random parameters drawn from ``generator`` (`transformer.init`) on
    ``device`` (CUDA unless ``"cpu"``), zero AdamW moments."""
    params = T.init(generator, cfg, device=device)
    return TrainState(params=params, opt=adamw_init(params))


def state_from_numpy(state, cfg: ArchConfig,
                     device: DeviceLike = None) -> TrainState:
    """The reference's TrainState with numpy leaves (``params``, ``opt``
    with ``step``, ``m``, ``v``) -> the port's, on ``device``, leaf dtypes
    kept (`transformer.params_from_numpy` for each tree)."""
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=T.params_from_numpy(state.params, cfg, device=dev),
        opt=AdamWState(
            step=torch.as_tensor(int(opt.step), dtype=torch.int32,
                                 device=dev),
            m=T.params_from_numpy(opt.m, cfg, device=dev),
            v=T.params_from_numpy(opt.v, cfg, device=dev)))


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    remat: bool = True, microbatch: Optional[int] = None,
                    compression: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "lr",
    "grad_norm"}), the metrics 0-dim tensors.

    The caller hands ``state`` over: the step writes the new parameters
    and moments into its tensors and returns them. A state that must
    outlive the step, such as a checkpoint's, is copied before the next
    step (`ckpt.checkpoint` copies to the host when it saves).

    microbatch: if set, the batch is cut into slices of that many rows and
    their gradients are summed in float32, one slice at a time (the memory
    lever), then averaged. compression: an optional params -> params QAT
    transform (`launch.train.make_compression`) applied to the forward
    only."""

    def loss_fn(params, batch):
        fwd_params = compression(params) if compression is not None \
            else params
        logits, aux = T.forward(fwd_params, batch, cfg, remat=remat)
        return losses.next_token_loss(logits, batch["tokens"], aux=aux)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def grads_of(params, batch):
        if microbatch is None:
            loss, grads = value_and_grad(params, batch)
            return loss, tree_unflatten(params, grads)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"microbatches of {microbatch}")
        n = B // microbatch
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        for i in range(n):
            mb = {k: v[i * microbatch:(i + 1) * microbatch]
                  for k, v in batch.items()}
            loss, grads = value_and_grad(params, mb)
            acc = [a + g.to(torch.float32) for a, g in zip(acc, grads)]
            loss_acc = loss_acc + loss
        return loss_acc / n, tree_unflatten(params, [a / n for a in acc])

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = grads_of(state.params, batch)
        with torch.no_grad():
            params, opt, metrics = adamw_update_(opt_cfg, grads, state.opt,
                                                 state.params)
        return TrainState(params, opt), dict(metrics, loss=loss)

    return train_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, state, tokens) -> (next_tokens (B, 1) int32,
    state). One new token per request against the persistent KV cache."""

    def serve_step(params, state, tokens):
        logits, state = T.decode_step(params, state, tokens, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, state

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, batch) -> last-position logits (B, V). batch:
    {"tokens"}, with "frames" (whisper) or "patches" (vision) as
    `transformer.forward` takes them. On a CUDA device every attention
    without a cache (self-attention, the encoder's, cross attention) runs
    through kernel K5 and every Mamba layer's selective scan through
    kernel K6."""

    def prefill_step(params, batch):
        logits, _ = T.forward(params, batch, cfg, remat=False)
        return logits[:, -1]

    return prefill_step
