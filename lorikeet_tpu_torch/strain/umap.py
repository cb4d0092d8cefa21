"""In-process UMAP embedding for variant-group clustering.

Replaces the reference's `flight fit` subprocess (rhysnewell/flight:
umap-learn + HDBSCAN, invoked at
reference/src/haplotype/haplotype_clustering_engine.rs:240-257) with a
self-contained, seeded implementation of the UMAP algorithm (McInnes et al.
2018): exact kNN -> smooth-kNN fuzzy simplicial set -> spectral
initialisation -> full-batch cross-entropy descent on the low-dimensional
layout.

Design notes: the inputs here are tiny ([n_variants, n_samples]
depth fractions, n rarely above a few thousand), so the optimisation is
dense O(n^2) host numpy — one BLAS-bound matmul per epoch — rather than a
device kernel, which would never amortise at this size.  Full-batch descent replaces umap-learn's
negative-sampling SGD, which makes the layout deterministic for a given
seed.
"""
from __future__ import annotations

import numpy as np

#: curve parameters fit to min_dist=0.1, spread=1.0 (umap-learn
#: find_ab_params output, the library defaults)
_A, _B = 1.57694346, 0.89506088
_SMOOTH_K_TOLERANCE = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def _knn(X: np.ndarray, k: int):
    """Exact k-nearest neighbours (squared-euclidean argsort)."""
    d2 = np.maximum(
        (X * X).sum(1)[:, None] + (X * X).sum(1)[None, :] - 2.0 * X @ X.T,
        0.0)
    order = np.argsort(d2, axis=1)[:, 1:k + 1]
    dists = np.sqrt(np.take_along_axis(d2, order, axis=1))
    return order, dists


def _smooth_knn_dist(dists: np.ndarray, k: int, n_iter: int = 64):
    """Per-point (rho, sigma): rho = distance to nearest neighbour, sigma
    solves sum_j exp(-(d_ij - rho)/sigma) = log2(k) by bisection
    (umap-learn smooth_knn_dist)."""
    target = np.log2(k)
    rho = np.where(dists[:, 0] > 0, dists[:, 0], 0.0)
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    mid = np.ones(len(dists))
    adj = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-adj / mid[:, None]).sum(1)
        done = np.abs(psum - target) < _SMOOTH_K_TOLERANCE
        if done.all():
            break
        too_big = psum > target
        hi = np.where(~done & too_big, mid, hi)
        lo = np.where(~done & ~too_big, mid, lo)
        mid = np.where(~done & too_big, (lo + mid) / 2.0,
                       np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0))
    mean_d = dists.mean()
    floor = np.where(rho > 0, _MIN_K_DIST_SCALE * dists.mean(1),
                     _MIN_K_DIST_SCALE * mean_d)
    return rho, np.maximum(mid, floor)


def fuzzy_simplicial_set(X: np.ndarray, n_neighbors: int) -> np.ndarray:
    """Symmetrised membership matrix P (dense [n, n], zero diagonal):
    P = A + A^T - A*A^T with A the directed smooth-kNN memberships."""
    n = len(X)
    k = min(n_neighbors, n - 1)
    idx, dists = _knn(X, k)
    rho, sigma = _smooth_knn_dist(dists, k)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    A = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    A[rows, idx.ravel()] = w.ravel()
    P = A + A.T - A * A.T
    np.fill_diagonal(P, 0.0)
    return P


def _spectral_init(P: np.ndarray, n_components: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Symmetric-normalised Laplacian eigenvectors (umap-learn
    spectral_layout), with a small deterministic jitter."""
    deg = P.sum(1)
    with np.errstate(divide="ignore"):
        inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)),
                            0.0)
    L = np.eye(len(P)) - inv_sqrt[:, None] * P * inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(L)
    Y = vecs[:, 1:n_components + 1]
    expansion = 10.0 / max(np.abs(Y).max(), 1e-12)
    return Y * expansion + rng.normal(0, 1e-4, Y.shape)


def umap_embed(X: np.ndarray, n_components: int = 2, n_neighbors: int = 15,
               n_epochs: int = 200, learning_rate: float = 1.0,
               seed: int = 42, repulsion_strength: float = 1.0) -> np.ndarray:
    """Seeded UMAP layout of X [n, d] -> [n, n_components]."""
    X = np.asarray(X, np.float64)
    n = len(X)
    if n <= n_components + 1:
        return X[:, :n_components].copy() if X.shape[1] >= n_components \
            else np.pad(X, ((0, 0), (0, n_components - X.shape[1])))
    rng = np.random.default_rng(seed)
    P = fuzzy_simplicial_set(X, n_neighbors)
    Y = _spectral_init(P, n_components, rng)

    # Repulsion scaling: umap-learn applies `negative_sample_rate` (5)
    # repulsive updates per 1-simplex per epoch, i.e. ~5*k*n of the n^2
    # pairs — a per-pair weight of ~5k/n.  The full-batch stand-in must
    # match that scaling or repulsion grows linearly with n and inflates
    # clusters until they merge under HDBSCAN (observed at n~300: two
    # orthogonal strain profiles embedded as one overlapping smear).
    k_eff = min(n_neighbors, n - 1)
    rep = repulsion_strength * 5.0 * k_eff / max(n - 1, 1)

    eps = 1e-3
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        sq = (Y * Y).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 0.0)
        denom = 1.0 + _A * np.power(np.maximum(d2, eps), _B)
        # umap-learn gradient coefficients on (Y_i - Y_j): attractive
        # -2ab d^{2(b-1)}/(1+a d^{2b}); repulsive 2 gamma b /
        # ((eps + d^2)(1 + a d^{2b})), weighted P vs (1-P) (full-batch
        # stand-in for negative sampling)
        grad_att = -2.0 * _A * _B * np.power(np.maximum(d2, eps),
                                             _B - 1.0) / denom
        grad_rep = 2.0 * rep * _B / ((eps + d2) * denom)
        coeff = P * grad_att + (1.0 - P) * grad_rep
        np.fill_diagonal(coeff, 0.0)
        # sum_j coeff_ij (Y_i - Y_j) without materialising [n, n, c]
        grad = np.clip(Y * coeff.sum(1)[:, None] - coeff @ Y, -4.0, 4.0)
        Y = Y + alpha * grad
    return Y
