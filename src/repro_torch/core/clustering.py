"""Weight clustering (paper §II-C), in PyTorch.

Two granularities, as in `repro.core.clustering`:

* `kmeans_layer`: one codebook for a whole layer (Deep Compression).
* `cluster_per_input`: the paper's hardware form. Weights in the same input
  row share values, so the bespoke circuit computes each product x_i * c
  once and fans it out; its codebooks feed the clustered matmul K3.

1-D Lloyd k-means with quantile initialisation, matching the reference
operation for operation: ``jnp.quantile``'s "linear" rule, first-index
argmin, centroid sums through a one-hot. One batched implementation
(`kmeans_rows`) serves both granularities here and the per-candidate-k path
of `core.batch_eval`.
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


def kmeans_layer(w: torch.Tensor, k: int, iters: int = 25):
    """One codebook for the whole layer. -> (codebook (k,), idx w.shape
    int32)."""
    cent, a = _kmeans_1d(w.to(torch.float32).reshape(-1), k, iters)
    return cent, a.reshape(w.shape)


def cluster_per_input(w: torch.Tensor, k: int, iters: int = 25):
    """k-means per input row. w: (d_in, d_out) -> (codebooks (d_in, k),
    idx (d_in, d_out) int32). Rows are independent, so a caller may run
    the rows in chunks."""
    kk = torch.full((w.shape[0],), k, dtype=torch.int64, device=w.device)
    return kmeans_rows(w.to(torch.float32), kk, k, iters)


def reconstruct_layer(codebook: torch.Tensor, idx: torch.Tensor):
    """codebook (k,), idx (any shape) -> w of idx's shape."""
    return codebook[idx.long()]


def reconstruct_per_input(codebooks: torch.Tensor, idx: torch.Tensor):
    """codebooks (d_in, k), idx (d_in, d_out) -> w (d_in, d_out)."""
    return torch.gather(codebooks, 1, idx.long())


def _snap(w: torch.Tensor, k: int, per_input: bool) -> torch.Tensor:
    if per_input and w.dim() == 2:
        return reconstruct_per_input(*cluster_per_input(w, k))
    return reconstruct_layer(*kmeans_layer(w, k))


def cluster_ste(w: torch.Tensor, k: int, *,
                per_input: bool = True) -> torch.Tensor:
    """Cluster-aware training forward: snap to the codebook (per input row
    for a 2-D ``w`` when ``per_input``, else one per layer), identity
    gradient."""
    wd = w.detach()
    return w + (_snap(wd, k, per_input).to(w.dtype) - wd)


# ---------------------------------------------------------------------------
# hardware statistics
# ---------------------------------------------------------------------------


def multipliers_needed(idx: torch.Tensor, codebooks: torch.Tensor) -> int:
    """Bespoke multiplier count after per-input sharing: for each input row,
    one multiplier per *distinct, non-zero* cluster actually used."""
    used = torch.zeros(codebooks.shape, dtype=torch.bool,
                       device=codebooks.device)
    used.scatter_(1, idx.long(), True)
    return int((used & (torch.abs(codebooks) > 1e-8)).sum())


def clustering_error(w: torch.Tensor, k: int, *,
                     per_input: bool = True) -> float:
    """||w - snapped w|| / ||w|| (the denominator floored at 1e-9)."""
    err = torch.linalg.vector_norm(w - _snap(w, k, per_input))
    return float(err / torch.clamp_min(torch.linalg.vector_norm(w), 1e-9))
