"""Closed-form ADRF oracles, the latent-dimension estimator (sliced inverse
regression and PCA) and MNIST's inpainting masks (port of
``bayesgm_tpu/utils/helpers.py``, numpy and scipy: scikit-learn's
``StandardScaler`` and ``PCA`` are replaced by their arithmetic)."""

from __future__ import annotations

import warnings

import numpy as np


def get_ADRF(x_values=None, x_min=None, x_max=None, nb_intervals=None, dataset: str = "Imbens"):
    """Ground-truth dose-response curves of the simulations.

    Imbens: x + 2/(1+x)^3;  Sun: x - 1/2 + e^{-0.5} + 1;  Lee: 1.2x + x^3.
    The grid is ``x_values`` (a list or array) or a linspace of
    ``nb_intervals`` points over ``[x_min, x_max]``; float32.
    """
    known_curves = {"Imbens", "Sun", "Lee"}
    if dataset not in known_curves:
        raise ValueError(
            f"No closed-form ADRF oracle for dataset '{dataset}' "
            f"(available: {sorted(known_curves)}).")
    if x_values is not None:
        if not isinstance(x_values, (list, np.ndarray)):
            raise ValueError(
                "Pass the treatment grid `x_values` as a list or numpy array.")
        x_values = np.array(x_values, dtype="float32")
    elif None not in (x_min, x_max, nb_intervals):
        if x_min >= x_max:
            raise ValueError(
                f"Empty treatment range: x_min={x_min} is not below x_max={x_max}.")
        if nb_intervals <= 0:
            raise ValueError(
                f"Grid size nb_intervals={nb_intervals} should be >= 1.")
        x_values = np.linspace(x_min, x_max, nb_intervals, dtype="float32")
    else:
        raise ValueError(
            "Specify the treatment grid explicitly via `x_values`, or as a "
            "linspace via all three of `x_min`, `x_max`, `nb_intervals`.")

    if dataset == "Imbens":
        return x_values + 2.0 / (1.0 + x_values) ** 3
    if dataset == "Sun":
        return x_values - 0.5 + np.exp(-0.5) + 1.0
    return 1.2 * x_values + x_values**3


def slice_y(y, n_slices: int = 10):
    """Assign each sample (in sorted-y order) to one of up to ``n_slices``
    contiguous response slices, never splitting tied y values across slices
    (the slicing step of sliced inverse regression).  Returns
    ``(slice_ids (n,), counts_per_slice)``."""
    n = np.asarray(y).shape[0]
    _, tie_sizes = np.unique(y, return_counts=True)
    if tie_sizes.size == 1:
        raise ValueError(
            "slice_y requires at least two distinct response values; a "
            "constant target cannot be sliced for dimension reduction.")
    group_ends = np.cumsum(tie_sizes)  # end offset (in sorted order) of each tie group

    if n_slices >= tie_sizes.size:
        if n_slices > tie_sizes.size:
            warnings.warn(
                f"Requested {n_slices} slices but only {tie_sizes.size} "
                "distinct response values exist; using one slice per value.")
        cuts = np.concatenate(([0], group_ends))
    else:
        # greedy fill: each slice takes at least floor(n / n_slices) samples,
        # then extends to the end of the tie group it landed in
        per_slice = np.floor(n / n_slices)
        cuts = [0]
        filled = 0
        while filled < n - 2:
            g = np.searchsorted(group_ends, filled + per_slice, side="left")
            g = min(g, group_ends.size - 1)
            filled = group_ends[g]
            cuts.append(filled)
        cuts = np.asarray(cuts)

    slice_ids = np.zeros(n, dtype="int64")
    last = len(cuts) - 2
    for j in range(last + 1):
        hi = n if j == last else cuts[j + 1]
        slice_ids[cuts[j]:hi] = j
    return slice_ids, np.bincount(slice_ids)


def get_SDR_dim(X, y, n_slices: int = 10, ratio: float = 0.8):
    """Sufficient-dimension-reduction rank of the X -> y relation by SIR:
    whiten X with an economy QR, average the whitened rows within each
    y-slice, and count the eigenvalues of the between-slice covariance that
    reach ``ratio`` of its trace."""
    import scipy.linalg as linalg

    if y.ndim == 2:
        if y.shape[1] != 1:
            raise ValueError("The shape of y should be (n_samples, 1).")
        y = np.squeeze(y)
    n_samples = X.shape[0]
    Q, _ = linalg.qr(X - X.mean(axis=0), mode="economic")
    Z = np.sqrt(n_samples) * Q[np.argsort(y), :]

    slice_ids, counts = slice_y(y, n_slices)
    # per-slice sums by a one-hot contraction (Z's rows are in sorted-y order)
    onehot = (slice_ids[:, None] == np.arange(counts.size)[None, :])
    slice_means = (onehot.astype(Z.dtype).T @ Z) / np.sqrt(counts[:, None])
    M = slice_means.T @ slice_means / n_samples

    evals = linalg.eigh(M, eigvals_only=True)[::-1]
    reached = np.cumsum(evals) >= ratio * evals.sum()
    return int(np.argmax(reached) + 1)


def _float_array(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype.kind == "f" else a.astype(np.float64)


def standard_scale(a) -> np.ndarray:
    """``StandardScaler().fit_transform(a)`` by scikit-learn's arithmetic:
    the mean and the population variance by its corrected two-pass sums in
    float64 (Chan, Golub and LeVeque), a scale of 1 for a column
    indistinguishable from a constant, and the result in ``a``'s float
    type."""
    a = _float_array(a)
    n = a.shape[0]
    total = np.sum(a, axis=0, dtype=np.float64)
    mean = total / n
    centred = a - total / n  # float64
    correction = np.sum(centred, axis=0)
    centred **= 2
    var = (np.sum(centred, axis=0) - correction**2 / n) / n
    eps = np.finfo(np.float64).eps
    scale = np.sqrt(var)
    scale[var <= n * eps * var + (n * mean * eps) ** 2] = 1.0
    out = a.copy()
    out -= mean.astype(out.dtype)
    out /= scale.astype(out.dtype)
    return out


def pca_explained_variance_ratio(a) -> np.ndarray:
    """``PCA().fit(a).explained_variance_ratio_`` by scikit-learn's
    arithmetic and its ``svd_solver="auto"`` choice: for a tall matrix
    (``p <= 1000`` and ``n >= 10 p``) the eigenvalues of the covariance
    ``(X^T X - n m m^T) / (n - 1)``, clipped at 0, else the squared singular
    values of the centred matrix over ``n - 1``; each over their sum."""
    import scipy.linalg as linalg

    a = _float_array(a)
    n, p = a.shape
    mean = np.mean(a, axis=0)
    if p <= 1000 and n >= 10 * p:
        cov = a.T @ a
        cov -= n * mean.reshape(-1, 1) * mean.reshape(1, -1)
        cov /= n - 1
        explained = np.flip(np.linalg.eigh(cov)[0], axis=0)
        explained[explained < 0.0] = 0.0
    else:
        s = linalg.svd(a - mean, full_matrices=False)[1]
        explained = s**2 / (n - 1)
    return explained / np.sum(explained)


def estimate_latent_dims(x, y, v, v_ratio: float = 0.7, z0_dim: int = 3,
                         max_total_dim: int = 64, min_z3_dim: int = 3):
    """``[z0, z1, z2, z3]`` for CausalBGM: z1 and z2 by SIR of V -> y and
    V -> x on standardised V and y, the total by the number of principal
    components of V that explain ``v_ratio`` of its variance (at most
    ``max_total_dim``), z3 the rest (at least ``min_z3_dim``)."""
    v = standard_scale(v)
    y = standard_scale(y)
    z1_dim = get_SDR_dim(v, y, n_slices=10, ratio=0.8)
    z2_dim = get_SDR_dim(v, x, n_slices=10, ratio=0.8)
    cumulative = np.cumsum(pca_explained_variance_ratio(v))
    total_z_dim = int(np.argmax(cumulative >= v_ratio) + 1)
    total_z_dim = min(max_total_dim, total_z_dim)
    z3_dim = total_z_dim - z0_dim - z1_dim - z2_dim
    if z3_dim <= min_z3_dim:
        z3_dim = min_z3_dim
    return [z0_dim, z1_dim, z2_dim, z3_dim]


def mnist_mask_indices(shape=(28, 28), mode="hole", center=(14, 14), num_holes=1,
                       hole_size=3, orientation="horizontal", stripe_width=4,
                       stripe_pos=14, seed=None):
    """Pixel masks as ``(observed, missing)`` flat index arrays.

    Modes: ``'hole'``/``'holes'`` (a square of ``hole_size`` at ``center``, or
    at a seeded random centre where ``center`` is None), ``'edge_stripe'``
    (``stripe_width`` rows or columns at ``stripe_pos``), and the four half
    images ``'upper_half'``, ``'lower_half'``, ``'left_half'``,
    ``'right_half'``.  ``num_holes`` is accepted and unused, as in the JAX
    package.
    """
    H, W = shape
    mask = np.zeros((H, W), dtype=bool)  # True = missing

    if mode in ("hole", "holes"):
        rng = np.random.default_rng(seed)
        r = hole_size
        r2 = r // 2
        if center is None:
            valid_rows = np.arange(r2, H - (r - r2 - 1))
            valid_cols = np.arange(r2, W - (r - r2 - 1))
            center = (rng.choice(valid_rows), rng.choice(valid_cols))
        cy, cx = center
        mask[cy - r2:cy - r2 + r, cx - r2:cx - r2 + r] = True
    elif mode == "edge_stripe":
        w = int(stripe_width)
        start = stripe_pos - w // 2
        end = start + w
        if orientation == "horizontal":
            mask[start:end, :] = True
        elif orientation == "vertical":
            mask[:, start:end] = True
        else:
            raise ValueError(f"Unknown orientation: {orientation}")
    elif mode == "upper_half":
        mask[:H // 2, :] = True
    elif mode == "lower_half":
        mask[H // 2:, :] = True
    elif mode == "left_half":
        mask[:, :W // 2] = True
    elif mode == "right_half":
        mask[:, W // 2:] = True
    else:
        raise ValueError(f"Unknown mode: {mode}")
    return np.flatnonzero(~mask), np.flatnonzero(mask)
