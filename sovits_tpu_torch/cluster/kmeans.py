"""k-means on the tensors' device (counterpart of ``sovits_tpu/cluster/kmeans.py``).

kmeans++ seeding, then Lloyd steps. Distances use the expanded-norm form
``|x|^2 + |c|^2 - 2 x.c``, as the JAX package does, so near-ties break the
same way. The seeding draws from an explicit ``torch.Generator`` on the
device (JAX's draws cannot be matched) and keeps every step on the device:
a kmeans++ step samples by the exponential race (argmax of d / E, E ~
Exp(1)), which needs no host sync. A Lloyd step sums each cluster's points
with ``index_add_`` in place of JAX's dense one-hot product, which would be
[N, K] (7.2 GB at 180 000 x 10 000); an empty cluster keeps its center.
"""

from __future__ import annotations

import torch


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, K] via the expanded-norm matmul."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (centers * centers).sum(1)
    return x2 + c2[None, :] - 2.0 * (x @ centers.T)


def kmeans_plus_plus_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """kmeans++ seeding: each new center is a point drawn with probability
    proportional to its squared distance to the nearest center so far."""
    n = x.shape[0]
    x2 = (x * x).sum(1)
    centers = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    idx = torch.randint(n, (1,), generator=generator, device=x.device)
    min_d = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    race = torch.empty(n, dtype=x.dtype, device=x.device)
    for i in range(k):
        c = x.index_select(0, idx)[0]
        centers[i] = c
        min_d = torch.minimum(min_d, torch.addmv(x2 + (c * c).sum(), x, c, alpha=-2.0))
        if i + 1 < k:
            race.exponential_(generator=generator).clamp_(min=torch.finfo(x.dtype).tiny)
            idx = (min_d.clamp(min=0.0) / race).argmax().view(1)
    return centers


def lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``centers``; returns the final centers and
    each step's inertia (the sum of squared distances to the assigned
    centers, before that step's update), on the device."""
    k = centers.shape[0]
    inertia = torch.empty(iters, dtype=torch.float64, device=x.device)
    for i in range(iters):
        dist, assign = _sq_dists(x, centers).min(1)
        inertia[i] = dist.sum(dtype=torch.float64)
        sums = torch.zeros_like(centers).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp(min=1), centers)
    return centers, inertia


def kmeans_fit(features: torch.Tensor, n_clusters: int = 10000, iters: int = 50,
               seed: int = 0) -> torch.Tensor:
    """Fit k-means on ``features`` [N, D] (float32, on its device); returns
    the centers [K, D]. K is capped at N."""
    x = features.float()
    generator = torch.Generator(device=x.device).manual_seed(seed)
    centers = kmeans_plus_plus_init(x, min(n_clusters, x.shape[0]), generator)
    return lloyd(x, centers, iters)[0]


def kmeans_predict(features: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The index of each feature's nearest center."""
    return _sq_dists(features.float(), centers.float()).argmin(1)


def nearest_centers(features: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Each feature replaced by its nearest center (so-vits-svc's cluster/__init__.py)."""
    return centers[kmeans_predict(features, centers)]
