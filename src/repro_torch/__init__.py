"""PyTorch/CUDA port of `repro`'s printed-MLP minimization path.

The package mirrors `repro`'s module layout (``repro_torch.core.minimize``
is the counterpart of ``repro.core.minimize`` and so on) and imports neither
JAX nor anything of `repro`. Entry points take an explicit ``device``: they
run on CUDA unless the caller passes ``"cpu"``, and raise when no card is
present instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_DEFAULT_DEVICE = "cuda"


def set_default_device(device: str) -> None:
    """What ``device=None`` means in every entry point: ``"cuda"`` (the
    default) or ``"cpu"`` (`configs.backend.set_platform`)."""
    global _DEFAULT_DEVICE
    if device not in ("cuda", "cpu"):
        raise ValueError(f"default device {device!r}: cuda or cpu")
    _DEFAULT_DEVICE = device


def resolve_device(device: DeviceLike = None, *,
                   meta: bool = False) -> torch.device:
    """``None`` means CUDA (unless `configs.backend.set_platform` chose the
    CPU). A CUDA device without a card raises; the CPU is used only when
    the caller asks for it. ``meta`` lets ``"meta"`` through, for the
    initializers alone (`launch.specs` builds shapes on it and draws
    nothing)."""
    dev = torch.device(_DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu") and not (meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless device='cpu' is passed, and "
                "no CUDA device is available")
        if dev.index is None:          # one spelling per card (cache keys)
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
