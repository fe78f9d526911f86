"""Result files and input loaders (port of ``save_data``, ``parse_file`` and
``parse_file_triplet`` in ``bayesgm_tpu/utils/data_io.py``, with numpy alone:
where the JAX package reads a ``.csv`` with pandas, this reads it with
``np.loadtxt``, skipping the header row)."""

from __future__ import annotations

import os

import numpy as np


def _standardize(a: np.ndarray) -> np.ndarray:
    mean = a.mean(axis=0)
    std = a.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return ((a - mean) / std).astype("float32")


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


def _read_csv(path: str, sep: str, header) -> np.ndarray:
    """A numeric table as ``pd.read_csv(path, header=header, sep=sep).values``
    gives it: ``header=k`` takes row k as the column names and skips rows
    0..k, ``header=None`` skips nothing.  The array is column-major, as
    pandas returns it, so that the column means of the standardisation sum
    in the same order and give the same bits."""
    if header is None:
        skip = 0
    elif isinstance(header, int) and not isinstance(header, bool) and header >= 0:
        skip = header + 1
    else:
        raise ValueError(f"header={header!r}: expected None or a row number")
    return np.asfortranarray(np.loadtxt(path, delimiter=sep, skiprows=skip, ndmin=2))


def _unsupported(path: str):
    raise SystemExit(
        f"Unsupported input file '{path}': expected a .npz, .csv or .txt extension.")


def parse_file(path: str, sep: str = "\t", header=0, normalize: bool = True):
    """Load one data matrix from .npz (key data, x or X, else the first),
    .csv or .txt, as float32; standardised columns with ``normalize``."""
    assert os.path.exists(path), f"File not found: {path}"
    if path.endswith("npz"):
        loaded = np.load(path)
        for key in ("data", "x", "X"):
            if key in loaded:
                data = loaded[key]
                break
        else:
            data = loaded[list(loaded.keys())[0]]
    elif path.endswith("csv"):
        data = _read_csv(path, sep, header)
    elif path.endswith("txt"):
        data = np.loadtxt(path, delimiter=sep)
    else:
        _unsupported(path)
    data = data.astype("float32")
    if normalize:
        data = _standardize(data)
    return data


def parse_file_triplet(path: str, sep: str = "\t", header=0, normalize: bool = True):
    """Load an ``(x, y, v)`` triplet: a .npz with keys x, y and v, or a
    table (.csv or .txt) with the treatment in column 0, the outcome in
    column 1 and the covariates after; v standardised with ``normalize``."""
    assert os.path.exists(path)
    if path.endswith("npz"):
        data = np.load(path)
        data_x, data_y, data_v = data["x"], data["y"], data["v"]
    elif path.endswith("csv") or path.endswith("txt"):
        data = (_read_csv(path, sep, header) if path.endswith("csv")
                else np.loadtxt(path, delimiter=sep))
        data_x = data[:, 0].reshape(-1, 1).astype("float32")
        data_y = data[:, 1].reshape(-1, 1).astype("float32")
        data_v = data[:, 2:].astype("float32")
    else:
        _unsupported(path)
    if normalize:
        data_v = _standardize(data_v)
    return data_x, data_y, data_v
