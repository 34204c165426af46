"""k-means for per-slide feature clustering (counterpart of
``murcl_tpu/preprocess/kmeans.py``; reference
``wsi_processing/features_clustering.py:10-25``, scikit-learn's ``KMeans(K,
random_state=985)``).

k-means++ seeding, then Lloyd's iterations, for ``n_init`` restarts at once:
each iteration is one ``(n_init, N, K)`` distance product ``|x|^2 - 2 x.c^T
+ |c|^2`` and one one-hot product for the cluster sums, on the features'
device; a restart stops when its centres move less than ``tol`` times the
mean feature variance (scikit-learn's rule), an empty cluster keeps its
centre, and ``argmin`` breaks ties to the lowest index. The restart of
least inertia wins. One host sync per iteration reads whether any restart
is still moving. The seeding's draws come from a CPU ``torch.Generator``
seeded with ``seed`` and are placed on the CDF on the device, and the
arithmetic is f64, so the card and the CPU start from the same centres and
take the same iterations: in f32 the last bits of cuBLAS's and the CPU's
products differ, a point about equidistant from two centres changes sides,
and a restart ends in another minimum. ``backend="sklearn"`` runs
scikit-learn where it imports.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _sq_dist(x: torch.Tensor, x_sq: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``(R, N, K)`` squared distances of ``x (N, D)`` to ``centers (R, K, D)``."""
    c_sq = (centers * centers).sum(-1)  # (R, K)
    return x_sq[None, :, None] - 2.0 * torch.matmul(x, centers.transpose(1, 2)) + c_sq[:, None]


def plusplus_init(x: torch.Tensor, k: int, n_init: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """``(n_init, K, D)`` k-means++ centres (D^2 sampling); ``generator`` is a
    CPU generator whatever ``x``'s device."""
    n = x.shape[0]
    x_sq = (x * x).sum(-1)
    first = torch.randint(n, (n_init,), generator=generator).to(x.device)
    centers = [x[first]]  # (R, D) each
    d2 = _sq_dist(x, x_sq, centers[0][:, None])[..., 0].clamp_min(0)  # (R, N)
    for _ in range(1, k):
        w = torch.where(d2.sum(1, keepdim=True) > 0, d2, torch.ones_like(d2))
        cdf = torch.cumsum(w, dim=1)
        u = torch.rand(n_init, 1, generator=generator, dtype=torch.float64).to(x.device)
        idx = torch.searchsorted(cdf, (u * cdf[:, -1:].double()).to(cdf.dtype), right=True)
        c = x[idx[:, 0].clamp_max(n - 1)]
        centers.append(c)
        d2 = torch.minimum(d2, _sq_dist(x, x_sq, c[:, None])[..., 0].clamp_min(0))
    return torch.stack(centers, dim=1)


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int = 300, tol: float = 0.0):
    """Lloyd's iterations from ``centers (R, K, D)``, each restart until its
    squared centre shift is at most ``tol`` (already scaled) or ``max_iter``.
    Returns ``(centers, labels (R, N), inertia (R,), iterations (R,))``."""
    x_sq = (x * x).sum(-1)
    r, k, _ = centers.shape
    active = torch.ones(r, dtype=torch.bool, device=x.device)
    iters = torch.zeros(r, dtype=torch.int64, device=x.device)
    for _ in range(max_iter):
        labels = _sq_dist(x, x_sq, centers).argmin(-1)  # (R, N)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (R, N, K)
        counts = onehot.sum(1)  # (R, K)
        sums = torch.matmul(onehot.transpose(1, 2), x)  # (R, K, D)
        new = torch.where(counts[..., None] > 0, sums / counts.clamp_min(1)[..., None], centers)
        shift = ((new - centers) ** 2).sum((1, 2))
        centers = torch.where(active[:, None, None], new, centers)
        iters += active
        active &= shift > tol
        if not bool(active.any()):  # the one host sync per iteration
            break
    d2 = _sq_dist(x, x_sq, centers)
    mind2, labels = d2.min(-1)
    return centers, labels, mind2.sum(-1), iters


def kmeans_torch(x: torch.Tensor, num_clusters: int, seed: int = 985, n_init: int = 10,
                 max_iter: int = 300, tol: float = 1e-4) -> dict:
    """The torch backend on ``x (N, D)`` on its device, in f64: ``{labels (N,),
    centers (K, D) f32, inertia, iterations}`` of the best restart."""
    x = x.to(torch.float64)
    tol = tol * float(x.var(dim=0, unbiased=False).mean())
    gen = torch.Generator().manual_seed(seed)
    centers, labels, inertia, iters = lloyd(x, plusplus_init(x, num_clusters, n_init, gen),
                                            max_iter, tol)
    best = int(inertia.argmin())
    return {"labels": labels[best], "centers": centers[best].float(),
            "inertia": float(inertia[best]), "iterations": int(iters[best])}


def kmeans(features: np.ndarray, num_clusters: int, seed: int = 985, n_init: int = 10,
           max_iter: int = 300, tol: float = 1e-4, backend: str = "torch",
           device: Optional[torch.device] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster ``(N, D)`` features into K groups on ``device`` (the CPU when
    None). Returns ``(labels int64 (N,), centers (K, D))``."""
    if backend == "sklearn":
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=num_clusters, random_state=seed, n_init=n_init,
                    max_iter=max_iter, tol=tol).fit(features)
        return km.labels_.astype(np.int64), km.cluster_centers_
    if backend != "torch":
        raise ValueError(f"k-means backend {backend!r}: 'torch' or 'sklearn'")
    x = torch.as_tensor(np.asarray(features, dtype=np.float32), device=device)
    out = kmeans_torch(x, num_clusters, seed, n_init, max_iter, tol)
    return out["labels"].cpu().numpy().astype(np.int64), out["centers"].cpu().numpy()
