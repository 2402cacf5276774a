"""Losses of the LM track, the PyTorch counterpart of `repro.train.losses`:
the same operations in the same order, in float32."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 0.0) -> torch.Tensor:
    """logits (B, T, V) float32, labels (B, T) integers -> scalar mean NLL.
    z_loss: the MaxText-style penalty on the squared log-partition, which
    keeps bf16 logits from drifting."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))
    logp = shifted - lse
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(nll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse[..., 0]
                                                       + m[..., 0]))
    return loss


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *, aux=0.0,
                    aux_weight: float = 0.01,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Shifted LM loss: predict tokens[t + 1] from logits[t]."""
    loss = softmax_xent(logits[:, :-1], tokens[:, 1:], z_loss=z_loss)
    return loss + aux_weight * aux
