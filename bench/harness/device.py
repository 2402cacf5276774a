"""Small device helpers the drivers share."""
from __future__ import annotations

import gc

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def generator(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g
