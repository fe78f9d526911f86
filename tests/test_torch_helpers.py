"""The port's latent-dimension estimator and the low-rank design matrix
against the JAX package's (which uses scikit-learn) and scikit-learn: the
SIR golden cases of ``tests/test_utils.py``, ``StandardScaler`` and
``PCA().explained_variance_ratio_`` by their arithmetic (both of PCA's
solver routes), ``estimate_latent_dims`` on 24 seeded inputs of several
shapes and both float types, and ``make_low_rank_matrix``."""

import numpy as np
import pytest

pytest.importorskip("torch")
from sklearn.datasets import make_low_rank_matrix as sk_low_rank  # noqa: E402
from sklearn.decomposition import PCA  # noqa: E402
from sklearn.preprocessing import StandardScaler  # noqa: E402

from bayesgm_tpu.datasets import simulators as jsim  # noqa: E402
from bayesgm_tpu.utils import helpers as jh  # noqa: E402
from bayesgm_torch.datasets import simulators as tsim  # noqa: E402
from bayesgm_torch.utils import helpers as th  # noqa: E402

# (n, p): n >= 10 p takes PCA's covariance route, the others its SVD route
SHAPES = [(300, 12), (2000, 50), (200, 40), (600, 80), (5000, 20), (150, 30)]


def _inputs(seed):
    """Correlated covariates of mixed scales with x and y on a few of them;
    every third case in float32 (what the samplers' ``load_all`` gives)."""
    rng = np.random.RandomState(seed)
    n, p = SHAPES[seed % len(SHAPES)]
    dtype = np.float32 if seed % 3 == 0 else np.float64
    v = rng.randn(n, p) @ rng.randn(p, p) * rng.uniform(0.1, 5.0, p)
    x = (v[:, :3].sum(axis=1) + 0.1 * rng.randn(n)).reshape(-1, 1)
    y = (np.sin(v[:, 3]) + v[:, 4] + 0.1 * rng.randn(n)).reshape(-1, 1)
    return x.astype(dtype), y.astype(dtype), v.astype(dtype)


def test_sir_slicing_golden():
    """The golden outputs of ``tests/test_utils.py::test_sir_slicing_golden``."""
    rng = np.random.RandomState(42)
    _, counts = th.slice_y(np.sort(rng.randn(101)), n_slices=7)
    assert counts.tolist() == [14, 14, 14, 14, 14, 14, 14, 3]
    y_tied = np.repeat(np.arange(5), [3, 10, 1, 40, 6]).astype(float)
    _, counts = th.slice_y(y_tied, n_slices=3)
    assert counts.tolist() == [54, 6]
    X = rng.randn(300, 12)
    y = X[:, 0] + 2 * X[:, 1] - X[:, 2] + 0.05 * rng.randn(300)
    assert th.get_SDR_dim(X, y.reshape(-1, 1), n_slices=10, ratio=0.8) == 2
    y2 = np.sin(X[:, 3]) + 0.05 * rng.randn(300)
    assert th.get_SDR_dim(X, y2.reshape(-1, 1), n_slices=8, ratio=0.9) == 3
    with pytest.raises(ValueError):
        th.slice_y(np.ones(10))
    with pytest.warns(UserWarning, match="distinct response values"):
        th.slice_y(np.array([0.0, 1.0, 1.0, 2.0]), n_slices=5)


@pytest.mark.parametrize("seed", range(24))
def test_estimate_latent_dims_matches_jax(seed):
    """The dims equal the JAX function's.  The standardised covariates equal
    ``StandardScaler``'s bit for bit and the PCA ratios ``PCA``'s within
    1e-12 (the same LAPACK calls on the same arrays: they are bit-equal
    here, and a cumulative ratio that sits on ``v_ratio`` could still flip
    the total if a LAPACK build summed otherwise)."""
    x, y, v = _inputs(seed)
    assert th.estimate_latent_dims(x, y, v) == jh.estimate_latent_dims(x, y, v)
    scaled = StandardScaler().fit_transform(v)
    ours = th.standard_scale(v)
    assert ours.dtype == scaled.dtype
    np.testing.assert_array_equal(ours, scaled)
    np.testing.assert_allclose(th.pca_explained_variance_ratio(ours),
                               PCA().fit(scaled).explained_variance_ratio_, rtol=0, atol=1e-12)
    for kw in (dict(v_ratio=0.5), dict(v_ratio=0.9, z0_dim=1, min_z3_dim=1)):
        assert th.estimate_latent_dims(x, y, v, **kw) == jh.estimate_latent_dims(x, y, v, **kw)


def test_standard_scale_constant_and_integer_columns():
    """A constant column gets a scale of 1 (centred to 0), as
    ``StandardScaler`` gives it; integer input becomes float64."""
    rng = np.random.RandomState(0)
    v = np.c_[rng.randn(50, 3), np.full(50, 7.0), rng.randint(0, 5, size=50)]
    np.testing.assert_array_equal(th.standard_scale(v), StandardScaler().fit_transform(v))
    ints = rng.randint(0, 9, size=(40, 3))
    assert th.standard_scale(ints).dtype == np.float64
    np.testing.assert_array_equal(th.standard_scale(ints), StandardScaler().fit_transform(ints))


@pytest.mark.parametrize("n,p,rank,seed", [(100, 5, 2, 0), (50, 80, 5, 3), (300, 30, 4, 123)])
def test_make_low_rank_matrix_equals_sklearn(n, p, rank, seed):
    """Bit-equal to scikit-learn's (the same RandomState draws in the same
    order, the same QR calls)."""
    np.testing.assert_array_equal(
        tsim.make_low_rank_matrix(n_samples=n, n_features=p, effective_rank=rank,
                                  random_state=seed),
        sk_low_rank(n_samples=n, n_features=p, effective_rank=rank, random_state=seed))


def test_simulate_regression_low_rank_equals_jax():
    """``simulate_regression(effective_rank=...)`` runs without
    scikit-learn and equals the JAX package's, which imports it."""
    for got, want in zip(tsim.simulate_regression(100, 5, 2, effective_rank=2),
                         jsim.simulate_regression(100, 5, 2, effective_rank=2)):
        np.testing.assert_array_equal(got, want)
