"""Synthetic data simulators (port of ``bayesgm_tpu/datasets/simulators.py``).

Plain numpy with the same generator calls, so the same seed gives the same
arrays in both packages."""

from __future__ import annotations

import numpy as np


def make_low_rank_matrix(n_samples=100, n_features=100, *, effective_rank=10,
                         tail_strength=0.5, random_state=None):
    """scikit-learn's ``make_low_rank_matrix`` with numpy and scipy: random
    orthonormal factors from the QR of ``(n_samples, k)`` normals, then of
    ``(n_features, k)`` normals (``k = min(n_samples, n_features)``), drawn
    in that order from ``RandomState(random_state)``, around the bell-shaped
    singular profile ``(1 - tail_strength) exp(-(i / effective_rank)^2) +
    tail_strength exp(-0.1 i / effective_rank)``."""
    import scipy.linalg as linalg

    generator = (random_state if isinstance(random_state, np.random.RandomState)
                 else np.random.RandomState(random_state))
    n = min(n_samples, n_features)
    u, _ = linalg.qr(generator.standard_normal(size=(n_samples, n)), mode="economic",
                     check_finite=False)
    v, _ = linalg.qr(generator.standard_normal(size=(n_features, n)), mode="economic",
                     check_finite=False)
    singular_ind = np.arange(n, dtype=np.float64)
    low_rank = (1 - tail_strength) * np.exp(-1.0 * (singular_ind / effective_rank) ** 2)
    tail = tail_strength * np.exp(-0.1 * singular_ind / effective_rank)
    s = np.identity(n) * (low_rank + tail)
    return np.dot(np.dot(u, s), v.T)


def simulate_regression(n_samples, n_features, n_targets, effective_rank=None, variance=None, random_state=123):
    """Linear regression generator with optional low-rank design
    (reference simulators.py:5-50).

    Returns ``(X, Y)`` with shapes ``(n, p)`` and ``(n, q)``.  The low-rank
    design (``effective_rank``) is :func:`make_low_rank_matrix`.
    """
    rng = np.random.RandomState(random_state)
    if effective_rank is None:
        X = rng.normal(size=(n_samples, n_features))
    else:
        X = 100 * make_low_rank_matrix(
            n_samples=n_samples, n_features=n_features,
            effective_rank=effective_rank, random_state=random_state,
        )
    X_aug = np.c_[np.ones(n_samples), X]
    beta = 0.1 * rng.uniform(0.0, 1.0, size=(1 + n_features, n_targets))
    mu = X_aug @ beta
    if variance is None:
        variance = 0.01 * np.mean(X**2, axis=1)
    variance = np.tile(variance, (n_targets, 1)).T
    Y = rng.normal(loc=mu, scale=np.sqrt(variance))
    return X, Y


def simulate_low_rank_data(n_samples=10000, z_dim=2, x_dim=4, rank=2, sigma_z=False, random_state=123):
    """Z ~ N(0, I); X | Z ~ N(A Z + b, D + W W^T), optionally Z-scaled
    covariance — ground truth for the low-rank BGM
    (reference simulators.py:53-121).  Returns ``(X, Z)``.
    """
    rng = np.random.RandomState(random_state)
    Z = rng.randn(n_samples, z_dim).astype(np.float32)

    A = np.array([[1.0, -0.5], [0.3, 0.8], [-0.7, 0.2], [0.5, 1.0]])
    b = np.array([0.0, 0.5, 1.0, 2.0])
    mu = Z @ A.T + b

    W = np.array([[0.25, 0.0], [0.25, 0.0], [0.0, 0.25], [0.0, 0.25]])
    D = np.diag([0.1, 0.1, 0.2, 0.2])

    if sigma_z:
        # Per-sample covariance scaled by z[0]: Sigma_i = D z0^2 + (W z0)(W z0)^T.
        scale = Z[:, 0]
        base = D + W @ W.T
        chol = np.linalg.cholesky(base)
        eps = rng.randn(n_samples, x_dim)
        X = (mu + (eps @ chol.T) * scale[:, None]).astype(np.float32)
    else:
        Sigma = D + W @ W.T
        chol = np.linalg.cholesky(Sigma)
        eps = rng.randn(n_samples, x_dim)
        X = (mu + eps @ chol.T).astype(np.float32)
    return X, Z


def simulate_heteroskedastic_data(n=1000, d=5, seed=42):
    """y = x1 + eps with sinusoidal sigma(x2) (reference simulators.py:123-161).

    Returns ``(X, Y, sigma)``.
    """
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    X2 = X[:, 1]
    sigma = np.where(X2 < -2, 0.1, np.where(X2 > 2, 2.0, 0.5 + 0.5 * np.sin(2 * np.pi * X2)))
    Y = X[:, 0] + rng.randn(n) * sigma
    return X, Y, sigma


def simulate_z_hetero(n=20000, k=3, d=19, seed=42):
    """Latent-factor heteroskedastic benchmark: X = 0.2 Z A^T + noise,
    Y = sin(Z w) + sigmoid-scaled noise (reference simulators.py:163-204).

    Returns ``(X, Y)``.
    """
    rng = np.random.RandomState(seed)
    Z = rng.randn(n, k)
    A = rng.randn(d, k)
    X = 0.2 * Z @ A.T + 0.1 * rng.randn(n, d)
    w = rng.randn(k)
    u = rng.randn(k)
    mean_Y = np.sin(Z @ w)
    std_Y = 0.1 + 0.5 / (1.0 + np.exp(-(Z @ u)))
    Y = mean_Y + std_Y * rng.randn(n)
    return X, Y
