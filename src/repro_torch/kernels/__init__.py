"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch counts.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"netlist_sim": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
