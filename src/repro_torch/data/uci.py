"""Seeded synthetic stand-ins for the paper's four UCI datasets.

The container is offline, so the real UCI files are unavailable (DESIGN.md
§4). Each generator reproduces the dataset *schema* (feature count, class
count, sample count, class imbalance) as a class-conditional Gaussian mixture
whose difficulty is tuned so the un-minimized baseline MLP accuracy lands
near the published range for that dataset. All draws are seeded — every run
of the benchmark suite sees identical data.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.configs.printed_mlp import PRINTED_MLPS, PrintedMLPConfig


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_samples: int
    n_features: int
    n_classes: int
    class_sep: float          # mixture separation (difficulty knob)
    noise: float
    imbalance: float          # geometric class-frequency decay


SPECS = {
    # whitewine: 4898 samples, 11 features, 7 quality levels, hard/overlapping
    "whitewine": DatasetSpec("whitewine", 4898, 11, 7, 1.05, 0.85, 0.55),
    # redwine: 1599 samples, 11 features, 6 levels
    "redwine": DatasetSpec("redwine", 1599, 11, 6, 1.10, 0.85, 0.60),
    # pendigits: 10992 samples, 16 features, 10 digits, fairly separable
    "pendigits": DatasetSpec("pendigits", 10992, 16, 10, 2.6, 0.55, 1.0),
    # seeds: 210 samples, 7 features, 3 varieties, separable
    "seeds": DatasetSpec("seeds", 210, 7, 3, 2.9, 0.50, 1.0),
}


def make_dataset(name: str, *, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (x_train, y_train, x_test, y_test); features min-max scaled to
    [0, 1] (printed ADC front-ends deliver unsigned fixed-point inputs)."""
    spec = SPECS[name]
    # zlib.crc32, NOT hash(): str hash is randomized per process and would
    # make "seeded" datasets process-dependent
    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    freqs = spec.imbalance ** np.arange(spec.n_classes)
    freqs = freqs / freqs.sum()
    counts = np.maximum((freqs * spec.n_samples).astype(int), 8)

    # class means on a low-dim manifold embedded in feature space
    basis = rng.normal(size=(spec.n_classes, spec.n_features))
    means = basis * spec.class_sep
    # shared covariance structure with per-class jitter
    mix = rng.normal(size=(spec.n_features, spec.n_features)) * 0.3
    xs, ys = [], []
    for c, n in enumerate(counts):
        z = rng.normal(size=(n, spec.n_features))
        x = means[c] + z @ (np.eye(spec.n_features) + mix) * spec.noise
        # mild nonlinearity so a linear model can't saturate the task
        x = x + 0.15 * np.sin(2.0 * x[:, ::-1])
        xs.append(x)
        ys.append(np.full(n, c, np.int32))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    lo, hi = x.min(axis=0), x.max(axis=0)
    x = (x - lo) / np.maximum(hi - lo, 1e-9)

    idx = rng.permutation(len(x))
    x, y = x[idx], y[idx]
    n_test = max(int(0.25 * len(x)), 16)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def dataset_for(cfg: PrintedMLPConfig, *, seed: int = 0):
    assert cfg.name in SPECS
    return make_dataset(cfg.name, seed=seed)
