"""Printed bespoke MLP classifiers (the paper's model family) in PyTorch.

Parameters are a plain dictionary ``{"layers": ({"w", "b"}, ...)}`` with
``w`` laid out ``(d_in, d_out)`` as in `repro.nn.mlp`, so weights carry
between the two packages unchanged (`params_from_numpy` /
`params_to_numpy`). A population of candidates stacks a leading ``P`` axis
on every leaf; `mlp_forward` broadcasts over it.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def mlp_init(generator: torch.Generator, layer_dims: Sequence[int], *,
             device=None, dtype=torch.float32):
    """layer_dims: (in, hidden..., out). Glorot-uniform weights drawn from
    ``generator`` (a CPU generator, so the draw does not depend on the
    device), zero biases. The JAX package draws with threefry, which torch
    cannot reproduce: tests inject the reference's weights instead."""
    params = []
    for d_in, d_out in zip(layer_dims[:-1], layer_dims[1:]):
        u = torch.rand((d_in, d_out), generator=generator,
                       dtype=torch.float32) * 2.0 - 1.0
        w = u * math.sqrt(6.0 / (d_in + d_out))
        params.append({"w": w.to(device=device, dtype=dtype),
                       "b": torch.zeros((d_out,), dtype=dtype,
                                        device=device)})
    return {"layers": tuple(params)}


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, F) -> logits (B, C); with population-stacked weights
    (P, d_in, d_out) -> (P, B, C). ReLU hidden activations."""
    hs = params["layers"]
    for i, layer in enumerate(hs):
        b = layer["b"]
        x = torch.matmul(x, layer["w"]) + (b if b.dim() == 1
                                           else b.unsqueeze(-2))
        if i < len(hs) - 1:
            x = torch.relu(x)
    return x


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(mlp_forward(params, x), -1) == y).float().mean(-1)


def params_from_numpy(params_np, device) -> dict:
    """The reference's ``{"layers": ({"w","b"}, ...)}`` of numpy arrays ->
    the same tree of float32 tensors on ``device``."""
    return {"layers": tuple(
        {k: torch.tensor(np.array(l[k], np.float32), device=device)
         for k in ("w", "b")} for l in params_np["layers"])}


def params_to_numpy(params) -> dict:
    """Inverse of `params_from_numpy`: one host copy per leaf."""
    return {"layers": tuple(
        {k: l[k].detach().cpu().numpy() for k in ("w", "b")}
        for l in params["layers"])}
