"""Mesh factories, the counterpart of `repro.launch.mesh`.

FUNCTIONS, not module-level constants: importing this module touches no
device. The meshes are abstract (`dist.sharding.AbstractMesh`, axis names
and sizes): the production ones are what the sharding rules resolve
against, the debug one is the single card the port runs on.
"""
from __future__ import annotations

from repro_torch.dist.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 256 chips (16 data x 16 model). Multi-pod: 2 x 256 with a
    leading `pod` axis that composes with `data` for batch parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> AbstractMesh:
    """The one-card mesh: every axis of size 1, every spec replicated."""
    return AbstractMesh(shape, axes)
