"""The causal datasets (port of ``bayesgm_tpu/datasets/causal_samplers.py``).

The simulations are plain numpy (and ``scipy.stats.norm`` for Colangelo)
with the same generator calls, so the same seed gives the same arrays in
both packages.  The semi-synthetic ACIC-2018 and Twins loaders read their
CSVs with :func:`~bayesgm_torch.utils.data_io.read_csv_table` where the JAX
package uses pandas, and keep pandas' semantics: the join's row order, the
column drops, the NaN and birthweight filters and the layout of ``v``.
"""

from __future__ import annotations

import os

import numpy as np

from bayesgm_torch.datasets.base_sampler import Base_sampler
from bayesgm_torch.utils.data_io import read_csv_table


def resolve_data_path(path, subdir: str, probe: str) -> str:
    """The directory of a semi-synthetic dataset: ``path`` when given, else
    ``$BAYESGM_DATA/<subdir>`` when the variable is set, else
    ``../data/<subdir>``.  Raises ``FileNotFoundError`` naming the
    variable when ``probe``, a file the loader is about to read, is not
    there."""
    if path is None:
        root = os.environ.get("BAYESGM_DATA")
        path = os.path.join(root, subdir) if root else os.path.join("..", "data", subdir)
    probe_path = os.path.join(path, probe)
    if not os.path.exists(probe_path):
        raise FileNotFoundError(
            f"Dataset file '{probe_path}' not found. Download the {subdir} "
            "data and either pass path=... or set the BAYESGM_DATA "
            f"environment variable to a directory containing '{subdir}/'.")
    return path


class Semi_acic_sampler(Base_sampler):
    """ACIC-2018 semi-synthetic loader (binary treatment).

    Joins the covariate table ``x.csv`` with the factuals
    ``scaling/factuals/{ufid}.csv`` on ``sample_id`` (an inner join in the
    order of ``x.csv``'s rows, as pandas' ``join`` makes it); the treatment
    is the ``z`` column, the outcome the ``y`` column, and ``v`` every
    joined column but the last two, column-major as pandas' ``.values``
    gives it (so the standardisation's column sums run in the same order).
    A ``sample_id`` repeated in either file raises ``ValueError`` (pandas'
    join would repeat the row).  The directory resolves through
    :func:`resolve_data_path` (``$BAYESGM_DATA``)."""

    def __init__(self, batch_size: int = 32, path: str | None = None,
                 ufid: str = "d5bd8e4814904c58a79d7cdcd7c2a1bb"):
        path = resolve_data_path(path, "ACIC_2018", "x.csv")
        _, cov_ids, cov = read_csv_table(f"{path}/x.csv", key="sample_id")
        sim_names, sim_ids, sim = read_csv_table(f"{path}/scaling/factuals/{ufid}.csv",
                                                 key="sample_id")
        for ids, name in ((cov_ids, "x.csv"), (sim_ids, f"{ufid}.csv")):
            if len(np.unique(ids)) != len(ids):
                raise ValueError(f"{name}: sample_id is not unique")
        order = np.argsort(sim_ids, kind="stable")
        at = np.searchsorted(sim_ids[order], cov_ids).clip(max=len(order) - 1)
        found = sim_ids[order][at] == cov_ids
        rows_cov, rows_sim = np.flatnonzero(found), order[at[found]]
        dataset = np.asfortranarray(np.hstack([cov[rows_cov], sim[rows_sim]]))
        x = dataset[:, cov.shape[1] + sim_names.index("z")].reshape(-1, 1)
        y = dataset[:, cov.shape[1] + sim_names.index("y")].reshape(-1, 1)
        v = dataset[:, :-2]
        super().__init__(x, y, v, batch_size=batch_size, normalize=True)


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


_TWINS_FILES = {part: f"twin_pairs_{part}_3years_samesex.csv" for part in "XTY"}


class Semi_Twins_sampler(Base_sampler):
    """Twins semi-synthetic dataset (continuous treatment: birthweight /
    1000).

    Reads the CSV trio, drops the covariates' first two columns and the
    ``infant_id_0``/``infant_id_1`` columns, drops the pairs with a NaN
    covariate and then those whose first twin weighs ``dbirwt_1 >= 2000``,
    stacks both twins and draws the outcome
    ``y = -2 sigmoid(3x) + V gamma + eps`` from ``RandomState(seed)``
    (``eps`` first, then ``gamma``).  ``auxiliary_constant`` is
    ``mean(V gamma)``, the true ADRF's offset.  The directory resolves
    through :func:`resolve_data_path` (``$BAYESGM_DATA``).  ``v`` is
    column-major, as pandas' ``.values`` gives it (so the standardisation's
    column sums run in the same order)."""

    def __init__(self, batch_size: int = 32, seed: int = 0, path: str | None = None):
        path = resolve_data_path(path, "Twins", _TWINS_FILES["X"])
        cov_names, _, cov = read_csv_table(f"{path}/{_TWINS_FILES['X']}")
        keep = [i for i, name in enumerate(cov_names)
                if i >= 2 and name not in ("infant_id_0", "infant_id_1")]
        cov = cov[:, keep]
        t_names, _, treatment = read_csv_table(f"{path}/{_TWINS_FILES['T']}")
        if not os.path.exists(f"{path}/{_TWINS_FILES['Y']}"):  # read, unused, by the JAX loader
            raise FileNotFoundError(f"{path}/{_TWINS_FILES['Y']} not found")
        treatment, t_names = treatment[:, 1:], t_names[1:]
        rows = ~np.isnan(cov).any(axis=1)
        rows &= ~(treatment[:, t_names.index("dbirwt_1")] >= 2000)
        cov, treatment = cov[rows], treatment[rows]

        x = np.concatenate([treatment[:, 0], treatment[:, 1]]) / 1000.0
        v = np.asfortranarray(np.concatenate([cov, cov]))  # column-major, as pandas' .values
        rng = np.random.RandomState(seed)
        eps = rng.normal(0, 0.25, size=(v.shape[0],))
        gamma = rng.normal(0, 0.025, size=(v.shape[1],))
        y = -2.0 / (1.0 + np.exp(-3.0 * x)) + v @ gamma + eps
        self.auxiliary_constant = float(np.mean(v @ gamma))
        super().__init__(x.reshape(-1, 1), y.reshape(-1, 1), v, batch_size=batch_size,
                         normalize=True)
