"""Abstract stand-ins and sharding specs for every (arch x shape) cell, the
counterpart of `repro.launch.specs`.

Where the reference uses ``jax.eval_shape``, the port builds on the
``meta`` device: `transformer.init` and `init_decode_state` there draw
nothing and allocate nothing, so a full-size state (deepseek-v2's 236 B
parameters, nemotron-4-340b's) is only shapes and dtypes. The dry-run
(`launch.dryrun`) counts its steps on these. The ``*_shardings`` functions
give spec trees (`dist.sharding.P`); `dist.sharding.placements` turns a
spec into a DTensor's placements on a real device mesh.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import P
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T
from repro_torch.train import train_state as TS
from repro_torch.train.optimizer import AdamWConfig, AdamWState

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _generator() -> torch.Generator:
    # never drawn from: every initializer returns an empty meta tensor
    return torch.Generator()


def batch_divisor(mesh) -> int:
    n = 1
    for a in SH.batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for the cell (training batch or decode tokens),
    meta tensors."""
    B = shape.global_batch
    if shape.kind == "decode":
        specs = {"tokens": _sds((B, 1), torch.int32)}
    else:
        specs = {"tokens": _sds((B, shape.seq_len), torch.int32)}
    dt = L.torch_dtype(cfg.dtype)
    if cfg.encoder is not None and shape.kind != "decode":
        specs["frames"] = _sds((B, cfg.encoder.num_frames, cfg.d_model), dt)
    if cfg.vision is not None and shape.kind != "decode":
        specs["patches"] = _sds((B, cfg.vision.num_patches, cfg.d_model), dt)
    return specs


def input_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh):
    specs = input_specs(cfg, shape)
    div = batch_divisor(mesh)
    baxes = SH.batch_axes(mesh) if shape.global_batch % max(div, 1) == 0 \
        else ()

    def spec(leaf):
        axes: list = [None] * leaf.dim()
        if baxes:
            axes[0] = baxes
        return P(*axes)

    return {k: spec(v) for k, v in specs.items()}


def abstract_train_state(cfg: ArchConfig) -> TS.TrainState:
    return TS.init_state(_generator(), cfg, AdamWConfig(), device=META)


def train_state_shardings(cfg: ArchConfig, mesh, state_shapes=None):
    state_shapes = state_shapes if state_shapes is not None \
        else abstract_train_state(cfg)
    pspecs = SH.param_specs(state_shapes.params, mesh)
    return TS.TrainState(params=pspecs,
                         opt=AdamWState(step=P(), m=pspecs, v=pspecs))


def abstract_decode_state(cfg: ArchConfig, shape: ShapeConfig,
                          kv_dtype=None):
    B = shape.global_batch
    dtype = L.torch_dtype(kv_dtype) if kv_dtype else \
        L.torch_dtype(cfg.dtype)
    return T.init_decode_state(cfg, B, shape.seq_len, dtype, device=META)


def decode_state_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                           state_shapes=None):
    state_shapes = state_shapes if state_shapes is not None \
        else abstract_decode_state(cfg, shape)
    # batch too small to shard (long_500k B=1): replicate the batch dim
    ok = shape.global_batch % max(batch_divisor(mesh), 1) == 0
    return SH.cache_specs(state_shapes, mesh, cfg, shard_batch=ok)


def abstract_params(cfg: ArchConfig):
    return T.init(_generator(), cfg, device=META)


def param_shardings(cfg: ArchConfig, mesh, params_shapes=None):
    params_shapes = params_shapes if params_shapes is not None \
        else abstract_params(cfg)
    return SH.param_specs(params_shapes, mesh)
