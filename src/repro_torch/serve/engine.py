"""Batched serving engine over the one-token decode step, the PyTorch
counterpart of `repro.serve.engine` (same waves, barrier and stats).

Slots: fixed ``batch`` decode lanes. Every slot shares one ``kv_len``, so a
wave of up to ``batch`` requests is prefilled token by token (prompts
left-padded with zeros to the longest) and decoded greedily until every
request of the wave is done; the next wave starts from a fresh cache
(barrier batching). Recurrent (Mamba, RG-LRU) caches take the same path:
the conv window and the state are updated in place by every step, and a
sliding-window layer's ring buffer takes its one token a step. An
encoder-decoder or vision model reads its cross-attention context, the
``enc_out`` given to `ServeEngine.run`, from every wave's fresh state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.nn import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0


class ServeEngine:
    """Single-host engine with greedy sampling and barrier batching.
    ``params`` must lie on ``device`` (CUDA unless ``"cpu"``); ``dtype`` is
    the caches' (a Mamba layer's state is float32 whatever it is)."""

    def __init__(self, params, cfg: ArchConfig, *, batch: int = 4,
                 max_len: int = 256, dtype=torch.float32,
                 device: DeviceLike = None):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.dtype = dtype
        self.device = resolve_device(device)
        self.stats = EngineStats()

    def _step(self, state, tokens: np.ndarray):
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        logits, state = T.decode_step(self.params, state, toks, self.cfg)
        self.stats.steps += 1
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt.cpu().numpy().astype(np.int32), state

    def run(self, requests: List[Request], *, enc_out=None) -> List[Request]:
        """Process all requests to completion, batch-barrier batching.
        ``enc_out``: the cross-attention context (B = ``batch``, frames or
        patches, d_model) every wave reads: the encoder's output
        (`transformer._encoder_forward`) or the patches."""
        queue = list(requests)
        while queue:
            wave, queue = queue[:self.batch], queue[self.batch:]
            self._run_wave(wave, enc_out)
        return requests

    def _fresh_state(self, enc_out=None):
        state = T.init_decode_state(self.cfg, self.batch, self.max_len,
                                    self.dtype, device=self.device)
        if enc_out is not None:
            state["enc_out"] = enc_out
        return state

    def _run_wave(self, wave: List[Request], enc_out=None):
        state = self._fresh_state(enc_out)
        B = self.batch
        maxp = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, maxp), np.int32)
        for i, r in enumerate(wave):
            toks[i, maxp - len(r.prompt):] = r.prompt
        nxt = None
        for t in range(maxp):
            nxt, state = self._step(state, toks[:, t:t + 1])
        max_new = max(r.max_new_tokens for r in wave)
        for _ in range(max_new):
            for i, r in enumerate(wave):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(nxt[i]))
                    self.stats.tokens_generated += 1
                    if r.eos_id is not None and nxt[i] == r.eos_id:
                        r.done = True
            if all(r.done or len(r.output) >= r.max_new_tokens for r in wave):
                break
            nxt, state = self._step(state, nxt[:, None])
        for r in wave:
            r.done = True
            self.stats.requests_completed += 1
