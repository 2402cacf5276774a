"""Per-input weight clustering (paper §II-C), in PyTorch.

Weights in the same input row share values, so the bespoke circuit computes
each product x_i * c once and fans it out. 1-D Lloyd k-means with quantile
initialisation, matching `repro.core.clustering` operation for operation:
``jnp.quantile``'s "linear" rule, first-index argmin, centroid sums through
a one-hot. One batched implementation (`kmeans_rows`) serves the static-k
path here and the per-candidate-k path of `core.batch_eval`.
"""
from __future__ import annotations

import torch


def _quantile_linear(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.quantile(row, q_row)`` ("linear"): x (R, N), q (R, K)
    -> (R, K), all float32. A row holding a NaN yields NaN, as in JAX.
    ``torch.quantile`` takes one q for all rows, hence the rule written
    out: low*(1-w) + high*w with w = q*(n-1) - floor(q*(n-1))."""
    x = torch.where(torch.isnan(x).any(-1, keepdim=True),
                    torch.full_like(x, float("nan")), x)
    xs = torch.sort(x, dim=-1).values
    n1 = float(x.shape[-1] - 1)
    pos = q * n1
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = torch.clamp(low, 0.0, n1).long()
    high = torch.clamp(high, 0.0, n1).long()
    return (torch.gather(xs, -1, low) * lw
            + torch.gather(xs, -1, high) * hw)


def kmeans_rows(x: torch.Tensor, k: torch.Tensor, k_max: int,
                iters: int = 25):
    """Independent 1-D k-means per row. x: (R, N) float32; k: (R,) cluster
    counts (1 <= k <= k_max). Slots >= k are held at +inf distance, so the
    valid slots reproduce a static-k run exactly.
    -> (centroids (R, k_max), assignments (R, N) int32)."""
    kf = k.to(torch.float32)[:, None]
    slots = torch.arange(k_max, dtype=torch.float32, device=x.device)[None]
    valid = (slots < kf)[:, None, :]                       # (R, 1, K)
    cent = _quantile_linear(x, torch.clamp((slots + 0.5) / kf, 0.0, 1.0))
    inf = torch.tensor(float("inf"), device=x.device)
    slot_ids = torch.arange(k_max, device=x.device)[None, :, None]

    def assign(cent):
        d = torch.abs(x[:, :, None] - cent[:, None, :])    # (R, N, K)
        return torch.argmin(torch.where(valid, d, inf), dim=2)

    for _ in range(iters):
        # one-hot laid out (R, K, N): each slot's sum runs along the
        # contiguous last axis, so its order depends on N alone and not on
        # k_max (and, unlike F.one_hot, the comparison never syncs the card)
        one = (assign(cent)[:, None, :] == slot_ids).to(torch.float32)
        cnt = one.sum(-1)
        s = (one * x[:, None, :]).sum(-1)
        cent = torch.where(cnt > 0, s / torch.clamp_min(cnt, 1.0), cent)
    return cent, assign(cent).to(torch.int32)


def _kmeans_1d(x: torch.Tensor, k: int, iters: int = 25):
    """x: (N,) float32 -> (centroids (k,), assign (N,) int32)."""
    kk = torch.full((1,), k, dtype=torch.int64, device=x.device)
    cent, a = kmeans_rows(x.to(torch.float32)[None], kk, k, iters)
    return cent[0], a[0]


def cluster_per_input(w: torch.Tensor, k: int, iters: int = 25):
    """k-means per input row. w: (d_in, d_out) -> (codebooks (d_in, k),
    idx (d_in, d_out) int32)."""
    kk = torch.full((w.shape[0],), k, dtype=torch.int64, device=w.device)
    return kmeans_rows(w.to(torch.float32), kk, k, iters)


def reconstruct_per_input(codebooks: torch.Tensor, idx: torch.Tensor):
    """codebooks (d_in, k), idx (d_in, d_out) -> w (d_in, d_out)."""
    return torch.gather(codebooks, 1, idx.long())


def cluster_ste(w: torch.Tensor, k: int) -> torch.Tensor:
    """Cluster-aware training forward: snap each row to its codebook,
    identity gradient."""
    wd = w.detach()
    cb, idx = cluster_per_input(wd, k)
    return w + (reconstruct_per_input(cb, idx).to(w.dtype) - wd)
