"""Result files (port of ``save_data`` in ``bayesgm_tpu/utils/data_io.py``)."""

from __future__ import annotations

import numpy as np


def save_data(fname: str, data, delimiter: str = "\t"):
    """Save an array as .npy, or as .txt/.csv with ``%.6f``."""
    data = np.asarray(data)
    if fname.endswith(".npy"):
        np.save(fname, data)
    elif fname.endswith(".txt") or fname.endswith(".csv"):
        np.savetxt(fname, data, fmt="%.6f", delimiter=delimiter)
    else:
        raise ValueError(f"Cannot infer an output format from '{fname}': supported "
                         "extensions are .npy, .txt and .csv.")
