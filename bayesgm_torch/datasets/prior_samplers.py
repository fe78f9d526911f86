"""Prior distribution samplers (port of
``bayesgm_tpu/datasets/prior_samplers.py``: plain numpy, and scipy for the
mixture's density, so the same seed gives the same arrays in both
packages)."""

from __future__ import annotations

import numpy as np


class Gaussian_sampler:
    """N(mu, sd^2 I) sampler with a pre-sampled training pool
    (reference prior_samplers.py:4-69)."""

    def __init__(self, mean, sd: float = 1.0, N: int = 20000):
        self.total_size = N
        self.mean = np.asarray(mean, dtype="float32")
        self.sd = sd
        self._rng = np.random.RandomState(1024)
        self.X = self._rng.normal(self.mean, self.sd, (N, len(self.mean))).astype("float32")

    def train(self, batch_size: int, label: bool = False):
        idx = self._rng.randint(0, self.total_size, size=batch_size)
        return self.X[idx, :]

    def get_batch(self, batch_size: int):
        return self._rng.normal(self.mean, self.sd, (batch_size, len(self.mean))).astype("float32")

    def load_all(self):
        return self.X


def _split_10_10(data):
    """90/10 test split then 90/10 val split (reference prior_samplers.py:110-118)."""
    n_test = int(0.1 * data.shape[0])
    data_test = data[-n_test:]
    data = data[:-n_test]
    n_val = int(0.1 * data.shape[0])
    data_val = data[-n_val:]
    data_train = data[:-n_val]
    return data_train, data_val, data_test


class GMM_indep_sampler:
    """Per-dimension independent 1-D Gaussian mixture with exact density
    (reference prior_samplers.py:71-172)."""

    def __init__(self, N, sd, dim, n_components, weights=None, bound: float = 1.0):
        self._rng = np.random.RandomState(1024)
        self.total_size = N
        self.dim = dim
        self.sd = sd
        self.n_components = n_components
        self.bound = bound
        self.centers = np.linspace(-bound, bound, n_components)
        self.X = np.vstack([self._generate_gmm(weights) for _ in range(dim)]).T
        self.X_train, self.X_val, self.X_test = _split_10_10(self.X)
        self.nb_train = self.X_train.shape[0]
        self.Y = None

    def _generate_gmm(self, weights=None):
        if weights is None:
            weights = np.ones(self.n_components) / self.n_components
        comp = self._rng.choice(self.n_components, size=self.total_size, replace=True, p=weights)
        return self._rng.normal(self.centers[comp], self.sd)

    def get_density(self, data):
        """Exact product-of-1D-GMM density at query points, shape (m,)."""
        from scipy.stats import norm

        assert data.shape[1] == self.dim
        dens = np.ones(len(data))
        for i in range(self.dim):
            # (n_components, m) component densities, uniform mixture weights
            p = norm.pdf(data[:, i][None, :], loc=self.centers[:, None], scale=self.sd)
            dens *= p.mean(axis=0)
        return dens

    def train(self, batch_size):
        idx = self._rng.randint(0, self.nb_train, size=batch_size)
        return self.X_train[idx, :]

    def load_all(self):
        return self.X, self.Y


class Swiss_roll_sampler:
    """Noisy swiss-roll (r sin(sr), r cos(sr)) sampler with KDE-style density
    (reference prior_samplers.py:175-265)."""

    def __init__(self, N, theta=2 * np.pi, scale=2, sigma=0.4):
        self._rng = np.random.RandomState(1024)
        self.total_size = N
        self.theta = theta
        self.scale = scale
        self.sigma = sigma
        params = np.linspace(0, theta, N)
        self.X_center = np.vstack((params * np.sin(scale * params), params * np.cos(scale * params)))
        self.X = self.X_center.T + self._rng.normal(0, sigma, size=(N, 2))
        self._rng.shuffle(self.X)
        self.X_train, self.X_val, self.X_test = _split_10_10(self.X)
        self.Y = None
        self.mean = 0
        self.sd = 0

    def train(self, batch_size, label: bool = False):
        idx = self._rng.randint(0, self.total_size, size=batch_size)
        return self.X[idx, :]

    def get_density(self, x_points):
        """Gaussian-kernel density against the noiseless curve, shape (m,)."""
        assert x_points.ndim == 2
        c = 1.0 / (2 * np.pi * self.sigma)
        diffs = x_points[:, None, :] - self.X_center.T[None, :, :]  # (m, N, 2)
        sq = np.sum(diffs**2, axis=-1)
        return c * np.mean(np.exp(-sq / (2 * self.sigma)), axis=1)

    def load_all(self):
        return self.X, self.Y
