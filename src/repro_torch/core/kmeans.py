"""K-Means (Lloyd's algorithm) in PyTorch — used for virtual-group
clustering (paper §IV-C2).

k-means++ seeding runs on the host with NumPy's generator (bit-identical
seeds to the JAX package); the Lloyd iterations run as plain tensor ops on
``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``[n, k]`` squared distances, summing the feature axis left to right
    (the order XLA uses for a short axis): the features are small integers,
    so ties are common and a reordered sum could flip an ``argmin``."""
    diff = x[:, None, :] - centers[None, :, :]
    sq = diff * diff
    d2 = sq[..., 0]
    for j in range(1, sq.shape[-1]):
        d2 = d2 + sq[..., j]
    return d2


def _lloyd(x: torch.Tensor, centers: torch.Tensor, k: int, iters: int):
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(x, centers), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = one_hot.sum(dim=0)
        sums = torch.matmul(one_hot.T, x)
        new_centers = sums / torch.clamp(counts[:, None], min=1.0)
        # keep empty clusters where they were
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    d2 = _sq_dist(x, centers)
    assign = torch.argmin(d2, dim=1)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    return centers, assign, inertia


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0
        )
        if d2.sum() <= 0:
            centers.append(x[rng.integers(n)])
            continue
        probs = d2 / d2.sum()
        centers.append(x[rng.choice(n, p=probs)])
    return np.stack(centers)


def kmeans(
    x: np.ndarray, k: int, iters: int = 25, seed: int = 0, device=None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Cluster rows of x into k groups.

    Returns (centers [k, dim], assignments [n], inertia).
    """
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    n, dim = x.shape
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centers0 = _kmeanspp_init(x, k, rng)
    centers, assign, inertia = _lloyd(torch.from_numpy(x).to(dev),
                                      torch.from_numpy(centers0).to(dev),
                                      k, iters)
    return (centers.cpu().numpy(), assign.cpu().numpy(),
            float(inertia.cpu()))
