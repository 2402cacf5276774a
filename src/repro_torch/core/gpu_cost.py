"""H100 roofline cost model for LM compression specs, the counterpart of
`repro.core.tpu_cost` (renamed: it prices on the card the port runs on).

The paper's GA prices candidates with the *printed circuit* area model. On
the card the deployment cost of a weight tree under a compression spec is
the roofline time of the serving step, dominated at decode by the weights'
traffic from device memory:

  bytes(layer) =  dense:      K*N*2                      (bf16)
                  quantized:  K*N*bits/8 + scales
                  clustered:  K*N*ceil(log2(k))/8 + codebooks
                  pruned(block): surviving_tiles/total * above

  t_mem = bytes/HBM_bw ;  t_compute = flops/peak  ;  cost = max(...)

This is the objective the GA minimizes for LM specs
(`repro_torch.examples.lm_compression`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from repro_torch.core.compression_spec import LayerMin, ModelMin
from repro_torch.dist.sharding import path_str
from repro_torch.nn import transformer as T
from repro_torch.roofline.hw import H100


@dataclasses.dataclass(frozen=True)
class LayerShape:
    K: int
    N: int


def layer_weight_bytes(shape: LayerShape, lm: LayerMin) -> float:
    """Device-memory bytes to stream one weight matrix under the spec."""
    n_weights = shape.K * shape.N
    keep = 1.0 - lm.sparsity            # block-sparse tiles skipped
    if lm.clusters is not None:
        idx_bits = max(math.ceil(math.log2(lm.clusters)), 1)
        codebook = shape.K * lm.clusters * 2          # per-row fp16 codebooks
        return keep * n_weights * idx_bits / 8.0 + codebook
    if lm.bits is not None:
        scales = shape.N * 2
        return keep * n_weights * lm.bits / 8.0 + scales
    return keep * n_weights * 2.0


def spec_cost_seconds(shapes, spec: ModelMin, *, batch_tokens: int = 1,
                      hw=H100, chips: int = 1) -> Dict[str, float]:
    """Decode-step roofline for a stack of layers under a spec.

    shapes: list[LayerShape] (one per spec layer). Returns the three terms
    and the max (the cost the GA minimizes)."""
    assert len(shapes) == len(spec.layers)
    total_bytes = sum(layer_weight_bytes(s, lm)
                      for s, lm in zip(shapes, spec.layers))
    total_flops = sum(2.0 * s.K * s.N * batch_tokens * (1.0 - lm.sparsity)
                      for s, lm in zip(shapes, spec.layers))
    t_mem = total_bytes / (chips * hw.hbm_bw)
    t_comp = total_flops / (chips * hw.peak_flops)
    return {"t_mem": t_mem, "t_comp": t_comp,
            "cost": max(t_mem, t_comp), "bytes": total_bytes,
            "flops": total_flops}


def lm_layer_shapes(params) -> Dict[str, LayerShape]:
    """2D+ matmul weight shapes of an LM parameter tree, keyed by path
    (`dist.sharding.path_str`): the compressible layer inventory for the
    GA."""
    out = {}
    for path, leaf in T._leaves(params):
        if hasattr(leaf, "shape") and len(leaf.shape) >= 2 \
                and leaf.shape[-1] >= 64 and leaf.shape[-2] >= 64:
            K = int(np.prod(leaf.shape[:-1]))
            out[path_str(path)] = LayerShape(K=K, N=int(leaf.shape[-1]))
    return out
