"""Pareto utilities: non-dominated sorting, crowding, hypervolume, and the
paper's headline metric — area gain at a bounded accuracy loss."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Minimization in every objective."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(a <= b) and np.any(a < b))


def non_dominated_sort(points: np.ndarray) -> List[np.ndarray]:
    """points (N, M), minimization. Returns list of index arrays per front."""
    n = len(points)
    S = [[] for _ in range(n)]
    counts = np.zeros(n, int)
    fronts: List[List[int]] = [[]]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if dominates(points[i], points[j]):
                S[i].append(j)
            elif dominates(points[j], points[i]):
                counts[i] += 1
        if counts[i] == 0:
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt = []
        for i in fronts[k]:
            for j in S[i]:
                counts[j] -= 1
                if counts[j] == 0:
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return [np.asarray(f, int) for f in fronts[:-1]]


def crowding_distance(points: np.ndarray) -> np.ndarray:
    n, m = points.shape
    d = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for k in range(m):
        order = np.argsort(points[:, k])
        d[order[0]] = d[order[-1]] = np.inf
        rng = points[order[-1], k] - points[order[0], k]
        if rng <= 0:
            continue
        d[order[1:-1]] += (points[order[2:], k] - points[order[:-2], k]) / rng
    return d


def first_front_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated points (minimization). Vectorized —
    three array ops on an (N, N, M) broadcast instead of the per-pair
    python loop, so it is the right primitive for hot paths (per-generation
    trace stats, the final front over every memoized evaluation)."""
    pts = np.asarray(points, float)
    a, b = pts[:, None, :], pts[None, :, :]
    dominated = ((b <= a).all(-1) & (b < a).any(-1)).any(1)
    return ~dominated


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the first front — same set and order as
    ``non_dominated_sort(points)[0]``."""
    return np.flatnonzero(first_front_mask(points))


def hypervolume_2d(points: np.ndarray, ref: Tuple[float, float]) -> float:
    """2-objective minimization hypervolume w.r.t. ref point."""
    pts = np.asarray(points, float)
    front = pts[pareto_front(pts)]
    front = front[np.argsort(front[:, 0])]
    hv, prev_y = 0.0, ref[1]
    for x, y in front:
        if x >= ref[0] or y >= prev_y:
            continue
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return hv


def gain_at_loss(points, *, baseline_acc: float, baseline_area: float,
                 max_loss: float = 0.05) -> float:
    """Paper metric: max area reduction factor among designs within
    ``max_loss`` absolute accuracy drop of the baseline. points: (acc, area).
    Returns 1.0 if nothing qualifies (the baseline itself)."""
    best = 1.0
    for acc, area in points:
        if acc >= baseline_acc - max_loss and area > 0:
            best = max(best, baseline_area / area)
    return best
