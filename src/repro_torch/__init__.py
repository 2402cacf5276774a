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


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises; the CPU is
    used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless device='cpu' is passed, and "
                "no CUDA device is available")
        if dev.index is None:          # one spelling per card (cache keys)
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
