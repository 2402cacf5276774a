"""Model configurations (copied from `repro.configs`): the printed-MLP
classifiers (`printed_mlp`) and the LM architectures of the serving track."""
from repro_torch.configs.base import (SHAPES, ArchConfig, LayerSpec, Segment,
                                      ShapeConfig, shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, ARCHS, get_arch

__all__ = ["ArchConfig", "LayerSpec", "Segment", "ShapeConfig", "SHAPES",
           "shape_applicable", "ARCHS", "ARCH_IDS", "get_arch"]
