"""The serve and prefill steps of `repro.train.train_state` (the train step
comes with the training slice of the port)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import transformer as T


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, state, tokens) -> (next_tokens (B, 1) int32,
    state). One new token per request against the persistent KV cache."""

    def serve_step(params, state, tokens):
        logits, state = T.decode_step(params, state, tokens, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, state

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, batch) -> last-position logits (B, V). On a
    CUDA device every layer's self-attention runs through kernel K5 and
    every Mamba layer's selective scan through kernel K6."""

    def prefill_step(params, batch):
        logits, _ = T.forward(params, batch, cfg)
        return logits[:, -1]

    return prefill_step
