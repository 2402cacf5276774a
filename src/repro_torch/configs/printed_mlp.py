"""The paper's own printed-MLP classifier configs (Mubarik et al. MICRO'20
baselines). Topologies follow the MICRO'20 bespoke classifiers: a single
small hidden layer sized per dataset.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PrintedMLPConfig:
    name: str
    n_features: int
    n_classes: int
    hidden: Tuple[int, ...]
    # baseline bespoke fixed-point precision (MICRO'20 uses 8-bit coefficients)
    baseline_bits: int = 8
    input_bits: int = 8

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        return (self.n_features,) + self.hidden + (self.n_classes,)


WHITEWINE = PrintedMLPConfig("whitewine", 11, 7, (10,))
REDWINE = PrintedMLPConfig("redwine", 11, 6, (10,))
PENDIGITS = PrintedMLPConfig("pendigits", 16, 10, (20,))
SEEDS = PrintedMLPConfig("seeds", 7, 3, (8,))

PRINTED_MLPS = {c.name: c for c in (WHITEWINE, REDWINE, PENDIGITS, SEEDS)}
