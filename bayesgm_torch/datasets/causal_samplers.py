"""The causal simulations (port of the simulated samplers of
``bayesgm_tpu/datasets/causal_samplers.py``).

Plain numpy (and ``scipy.stats.norm`` for Colangelo) with the same generator
calls, so the same seed gives the same arrays in both packages.  The
semi-synthetic ACIC and Twins loaders read external CSVs with pandas and are
not ported.
"""

from __future__ import annotations

import numpy as np

from bayesgm_torch.datasets.base_sampler import Base_sampler


class Sim_Hirano_Imbens_sampler(Base_sampler):
    """Hirano-Imbens continuous-treatment simulation:
    V ~ Exp(1)^{v_dim}; X | V ~ Exp(rate = V1 + V2);
    Y | X, V ~ N(X + (V1+V3) exp(-X (V1+V3)), 1); V is standardised.
    True ADRF: x + 2/(1+x)^3."""

    def __init__(self, batch_size: int = 32, N: int = 20000, v_dim: int = 200, seed: int = 0):
        rng = np.random.RandomState(seed)
        v = rng.exponential(scale=1.0, size=(N, v_dim))
        rate = v[:, 0] + v[:, 1]
        x = rng.exponential(scale=1.0 / rate)
        y = rng.normal(x + (v[:, 0] + v[:, 2]) * np.exp(-x * (v[:, 0] + v[:, 2])), 1)
        super().__init__(x.reshape(-1, 1), y.reshape(-1, 1), v, batch_size=batch_size,
                         normalize=True)


class Sim_Sun_sampler(Base_sampler):
    """Sun continuous-treatment simulation with trigonometric and polynomial
    confounding; V is standardised.  True ADRF: x - 1/2 + e^{-0.5} + 1."""

    def __init__(self, batch_size: int = 32, N: int = 20000, v_dim: int = 200, seed: int = 0):
        rng = np.random.RandomState(seed)
        v = rng.normal(0, 1, size=(N, v_dim))
        x = rng.normal(-2 * np.sin(2 * v[:, 0]) + (v[:, 1] ** 2 - 1.0 / 3) + (v[:, 2] - 0.5)
                       + np.cos(v[:, 3]), 1)
        y = rng.normal((v[:, 0] - 0.5) + np.cos(v[:, 1]) + v[:, 4] ** 2 + v[:, 5] + x, 1)
        super().__init__(x.reshape(-1, 1), y.reshape(-1, 1), v, batch_size=batch_size,
                         normalize=True)


class Sim_Colangelo_sampler(Base_sampler):
    """Colangelo continuous-treatment simulation with tridiagonal-covariance
    Gaussian covariates; V is standardised.  True ADRF: 1.2 x + x^3 (the
    'Lee' oracle)."""

    def __init__(self, batch_size: int = 32, N: int = 20000, v_dim: int = 100, seed: int = 0,
                 rho: float = 0.5, d: float = 1.0, a: float = 3.0, b: float = 0.75):
        from scipy.stats import norm

        rng = np.random.RandomState(seed)
        sigma = (np.eye(v_dim)
                 + rho * np.eye(v_dim, k=1)
                 + rho * np.eye(v_dim, k=-1))
        theta = 1.0 / np.arange(1, v_dim + 1) ** 2
        epsilon = rng.normal(0, 1, N)
        nu = rng.normal(0, 1, N)
        v = rng.multivariate_normal(np.zeros(v_dim), sigma, size=[N])
        x = d * norm.cdf(a * (v @ theta)) + b * nu - 0.5
        y = 1.2 * x + x**3 + x * v[:, 0] + 1.2 * (v @ theta) + epsilon
        super().__init__(x.reshape(-1, 1), y.reshape(-1, 1), v, batch_size=batch_size,
                         normalize=True)
