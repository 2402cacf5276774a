"""Compression specifications — the genome of the hardware-aware search.

A :class:`LayerMin` is the per-layer minimization choice (quantization bits,
pruning sparsity, cluster count); a :class:`ModelMin` is one choice per
compressible layer. The same spec drives:

* the printed-MLP path (`core.minimize`): QAT retraining + bespoke compile +
  printed-area objective (the paper, faithfully);
* the LM path of `repro` (not ported yet).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from repro_torch.core import clustering as C
from repro_torch.core import pruning as P
from repro_torch.core import quantization as Q


@dataclasses.dataclass(frozen=True)
class LayerMin:
    bits: Optional[int] = None         # None = full precision
    sparsity: float = 0.0
    clusters: Optional[int] = None     # None = no clustering
    # circuit-approximation genes (repro.approx; 0 = exact):
    csd_drop: int = 0                  # CSD digits dropped per multiplier
    lsb: int = 0                       # low bits truncated off accum trees

    def validate(self):
        assert self.bits is None or 2 <= self.bits <= 8, self.bits
        assert 0.0 <= self.sparsity <= 0.9, self.sparsity
        assert self.clusters is None or 2 <= self.clusters <= 64
        assert 0 <= self.csd_drop <= 8, self.csd_drop
        assert 0 <= self.lsb <= 16, self.lsb


@dataclasses.dataclass(frozen=True)
class ModelMin:
    layers: Tuple[LayerMin, ...]
    input_bits: int = 8
    argmax_lsb: int = 0                # argmax comparator-input truncation

    def validate(self):
        for l in self.layers:
            l.validate()
        assert 0 <= self.argmax_lsb <= 16, self.argmax_lsb

    @property
    def has_approx(self) -> bool:
        """Any circuit-approximation gene active — such specs must be
        priced structurally and scored on the simulated netlist (the
        analytic model and the float emulation describe the exact
        circuit, which is no longer what gets printed)."""
        return bool(self.argmax_lsb
                    or any(l.csd_drop or l.lsb for l in self.layers))

    def to_json(self) -> str:
        # approximation genes are serialized only when active, so every
        # exact spec keeps its historical JSON byte-for-byte (EvalCache
        # keys embed this string — old caches stay valid)
        layers = []
        for l in self.layers:
            d = {"bits": l.bits, "sparsity": l.sparsity,
                 "clusters": l.clusters}
            if l.csd_drop:
                d["csd_drop"] = l.csd_drop
            if l.lsb:
                d["lsb"] = l.lsb
            layers.append(d)
        out = {"input_bits": self.input_bits, "layers": layers}
        if self.argmax_lsb:
            out["argmax_lsb"] = self.argmax_lsb
        return json.dumps(out)

    @staticmethod
    def from_json(s: str) -> "ModelMin":
        d = json.loads(s)
        return ModelMin(tuple(LayerMin(**l) for l in d["layers"]),
                        d["input_bits"], d.get("argmax_lsb", 0))

    @staticmethod
    def uniform(n_layers: int, *, bits=None, sparsity=0.0, clusters=None,
                csd_drop: int = 0, lsb: int = 0, input_bits: int = 8,
                argmax_lsb: int = 0) -> "ModelMin":
        return ModelMin(tuple(LayerMin(bits, sparsity, clusters, csd_drop,
                                       lsb)
                              for _ in range(n_layers)), input_bits,
                        argmax_lsb)


def qat_weight(w: torch.Tensor, spec: LayerMin, mask=None) -> torch.Tensor:
    """QAT forward transform (prune -> cluster -> quantize), all STE.
    Order matters: the bespoke circuit hardwires quantized shared products of
    surviving connections, so quantization is the outermost grid snap."""
    if mask is not None:
        w = P.apply_mask(w, mask)
    if spec.clusters is not None and w.dim() == 2:
        w = C.cluster_ste(w, spec.clusters)
    if spec.bits is not None:
        w = Q.fake_quant(w, Q.QuantConfig(bits=spec.bits))
    return w
