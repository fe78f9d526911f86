"""Triplet ``(x, y, v)`` mini-batch sampler (port of
``bayesgm_tpu/datasets/base_sampler.py``, plain numpy: the same seed gives
the same batches in both packages)."""

from __future__ import annotations

import numpy as np


def _standardize(a: np.ndarray) -> np.ndarray:
    mean = a.mean(axis=0)
    std = a.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return ((a - mean) / std).astype("float32")


class Base_sampler:
    """Stores ``(x, y, v)`` as float32 and yields endless shuffled
    mini-batches.

    Parameters
    ----------
    x, y : array-like, shape (n,) or (n, 1)
        Treatment and outcome; reshaped to (n, 1).
    v : array-like, shape (n, v_dim)
        Covariates; standardised when ``normalize=True``.
    batch_size : int, default=32
    normalize : bool, default=False
    random_seed : int, default=123
    """

    def __init__(self, x, y, v, batch_size: int = 32, normalize: bool = False,
                 random_seed: int = 123):
        assert len(x) == len(y) == len(v)
        self._rng = np.random.RandomState(random_seed)
        self.data_x = np.asarray(x, dtype="float32")
        self.data_y = np.asarray(y, dtype="float32")
        self.data_v = np.asarray(v, dtype="float32")
        if self.data_x.ndim == 1:
            self.data_x = self.data_x.reshape(-1, 1)
        if self.data_y.ndim == 1:
            self.data_y = self.data_y.reshape(-1, 1)
        if normalize:
            self.data_v = _standardize(self.data_v)
        self.batch_size = batch_size
        self.sample_size = len(self.data_x)
        self.full_index = np.arange(self.sample_size)
        self._rng.shuffle(self.full_index)
        self._cursor = 0

    def _next_idx(self) -> np.ndarray:
        start, bs, n = self._cursor, self.batch_size, self.sample_size
        if start + bs <= n:
            idx = self.full_index[start : start + bs]
            self._cursor = (start + bs) % n
            if self._cursor == 0:
                self._rng.shuffle(self.full_index)
        else:
            # wrap around: the tail of this permutation and the head of the
            # same one, then reshuffle
            idx = np.hstack([self.full_index[start:], self.full_index[: start + bs - n]])
            self._rng.shuffle(self.full_index)
            self._cursor = 0
        return idx

    def next_batch(self):
        """Return the next mini-batch ``(x, y, v)``."""
        idx = self._next_idx()
        return self.data_x[idx, :], self.data_y[idx, :], self.data_v[idx, :]

    def load_all(self):
        """Return the full dataset ``(x, y, v)``."""
        return self.data_x, self.data_y, self.data_v
