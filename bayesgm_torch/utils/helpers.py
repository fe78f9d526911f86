"""Closed-form ADRF oracles (port of ``get_ADRF`` in
``bayesgm_tpu/utils/helpers.py``, plain numpy)."""

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
