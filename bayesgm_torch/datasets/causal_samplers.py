"""The causal simulation the port's checks train on (port of
``Sim_Hirano_Imbens_sampler`` in ``bayesgm_tpu/datasets/causal_samplers.py``).

Plain numpy with the same generator calls, so the same seed gives the same
arrays in both packages; only ``load_all`` is carried over, as the port's
training loop batches on the device.
"""

from __future__ import annotations

import numpy as np


def _standardize(a: np.ndarray) -> np.ndarray:
    mean = a.mean(axis=0)
    std = a.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return ((a - mean) / std).astype("float32")


class Sim_Hirano_Imbens_sampler:
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
        self.batch_size = batch_size
        self.data_x = x.reshape(-1, 1).astype("float32")
        self.data_y = y.reshape(-1, 1).astype("float32")
        self.data_v = _standardize(v.astype("float32"))
        self.sample_size = N

    def load_all(self):
        """Return the full dataset ``(x, y, v)``."""
        return self.data_x, self.data_y, self.data_v
