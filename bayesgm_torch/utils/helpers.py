"""Closed-form ADRF oracles and MNIST's inpainting masks (port of
``get_ADRF`` and ``mnist_mask_indices`` in ``bayesgm_tpu/utils/helpers.py``,
plain numpy)."""

from __future__ import annotations

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
