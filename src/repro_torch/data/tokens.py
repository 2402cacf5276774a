"""Synthetic LM token pipeline, a copy of `repro.data.tokens` (numpy only,
so its batches equal the reference's bit for bit): deterministic and
stateless (step -> batch), so training restarts reproduce the exact data
order (fault tolerance without a data-loader checkpoint).

The stream is a seeded order-2 Markov chain over the vocab — enough structure
for the 100M-model example to show a real falling loss curve (the model can
learn the transition table), unlike uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8       # out-degree of the Markov chain


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse deterministic transition structure
        self._succ = rng.integers(
            0, cfg.vocab_size,
            size=(min(cfg.vocab_size, 65536), cfg.branching)).astype(np.int32)

    def batch_at(self, step: int, *, host_id: int = 0,
                 n_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic batch for `step`; hosts draw disjoint slices of the
        global batch (host-local loading at scale)."""
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        local = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + host_id)
        toks = np.empty((local, cfg.seq_len), np.int32)
        state = rng.integers(0, self._succ.shape[0], size=local)
        toks[:, 0] = state
        for t in range(1, cfg.seq_len):
            choice = rng.integers(0, cfg.branching, size=local)
            state = self._succ[state % self._succ.shape[0], choice]
            toks[:, t] = state
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
