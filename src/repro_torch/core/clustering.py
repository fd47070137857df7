"""Size-penalized adaptive k-means over layer sigmas (SigmaQuant Eq. 2).

Objective:  min_{C, mu}  sum_j [ sum_{x in C_j} ||x - mu_j||^2
                                 + lambda * (|C_j| - N/K)^2 ]

The lambda term discourages degenerate clusters so layers spread across the
available bitwidths.  The solver is a host-side (numpy) Lloyd-style iteration
with a *sequential greedy reassignment* step that charges each point the
marginal size-penalty of joining a cluster — for the 1-D, small-N (number of
DNN layers) problems this converges in a handful of sweeps and is exactly
reproducible.
"""
from __future__ import annotations

import numpy as np

__all__ = ["adaptive_kmeans", "kmeans_objective", "assign_bits_to_clusters"]


def kmeans_objective(x: np.ndarray, labels: np.ndarray, k: int, lam: float) -> float:
    """Eq. 2 value for a given assignment (used by tests / the controller log)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    total = 0.0
    for j in range(k):
        members = x[labels == j]
        if len(members):
            mu = members.mean()
            total += float(((members - mu) ** 2).sum())
        total += lam * (len(members) - n / k) ** 2
    return total


def _init_centroids(x: np.ndarray, k: int) -> np.ndarray:
    """Quantile init — deterministic, well spread for 1-D features."""
    qs = (np.arange(k) + 0.5) / k
    return np.quantile(x, qs)


def adaptive_kmeans(
    x: np.ndarray,
    k: int = 4,
    lam: float = 0.1,
    *,
    max_iters: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster 1-D features ``x`` into ``k`` groups under Eq. 2.

    Returns ``(labels, centroids)`` with centroids sorted ascending and labels
    remapped accordingly (label 0 == smallest-sigma cluster).
    ``lam`` is interpreted relative to the data scale: the size penalty
    competes with squared distances, so it is multiplied by var(x) to stay
    meaningful across models whose sigmas live at very different magnitudes.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n = len(x)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(k)
    lam_eff = lam * max(float(np.var(x)), 1e-12)
    cents = _init_centroids(x, k)
    labels = np.argmin((x[:, None] - cents[None, :]) ** 2, axis=1)

    order = np.argsort(x)  # sequential sweep in sigma order keeps clusters contiguous
    for _ in range(max_iters):
        sizes = np.bincount(labels, minlength=k).astype(np.float64)
        changed = False
        for i in order:
            j_cur = labels[i]
            sizes[j_cur] -= 1
            # marginal cost of joining cluster j: distance + lambda * delta(size penalty)
            dist = (x[i] - cents) ** 2
            pen = lam_eff * ((sizes + 1 - n / k) ** 2 - (sizes - n / k) ** 2)
            j_new = int(np.argmin(dist + pen))
            sizes[j_new] += 1
            if j_new != j_cur:
                labels[i] = j_new
                changed = True
        # centroid update; respawn empty clusters at the farthest point
        for j in range(k):
            members = x[labels == j]
            if len(members):
                cents[j] = members.mean()
            else:
                far = int(np.argmax(np.min((x[:, None] - cents[None, :]) ** 2, axis=1)))
                cents[j] = x[far]
        if not changed:
            break

    # canonical order: cluster 0 = smallest centroid (lowest sigma -> lowest bits)
    rank = np.argsort(cents)
    remap = np.empty(k, dtype=np.int64)
    remap[rank] = np.arange(k)
    return remap[labels], cents[rank]


def assign_bits_to_clusters(
    labels: np.ndarray,
    bit_set: tuple[int, ...] = (2, 4, 6, 8),
    *,
    shift: int = 0,
) -> np.ndarray:
    """Map cluster rank -> bitwidth (low sigma -> low bits, §IV-B).

    ``shift`` moves the whole mapping along the bit ladder (zone response:
    +1 in the bit-increase zone, -1 in the bit-decrease zone) with clamping.
    """
    bit_set = tuple(sorted(bit_set))
    k = int(labels.max()) + 1 if len(labels) else len(bit_set)
    idx = np.clip(np.arange(k) + shift, 0, len(bit_set) - 1)
    lut = np.asarray([bit_set[i] for i in idx], dtype=np.int64)
    return lut[labels]
