"""Result files and input loaders (port of ``save_data``, ``parse_file`` and
``parse_file_triplet`` in ``bayesgm_tpu/utils/data_io.py``, with numpy alone:
where the JAX package reads a ``.csv`` with pandas, this reads it with
``np.loadtxt``, skipping the header row), and :func:`read_csv_table`, the
semi-synthetic loaders' reader of a table with named columns."""

from __future__ import annotations

import io
import os
import re

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


_EMPTY_FIELD = re.compile(r"(?<=,)(?=,|\r?\n|$)|^(?=,)", re.MULTILINE)


def read_csv_table(path: str, key: str | None = None):
    """A comma-separated table with a header row, as ``pd.read_csv`` reads
    it: ``(names, keys, values)``.  ``names`` are the header's column names
    (the key column's left out), ``values`` a float64 ``(rows, columns)``
    array in which an empty field is NaN, and ``keys`` the ``key`` column's
    strings (None without ``key``).

    Each value is the decimal string correctly rounded (numpy's parser).
    pandas' default parser keeps 17 digits, counting the zeros after the
    point, and builds the value in double arithmetic, so it can differ from
    this in the last bits: up to a relative 1e-12 for strings written with
    ``%.17g`` or by ``to_csv`` (three zeros after the point are the most
    either writes before it turns to an exponent)."""
    with open(path, newline="") as f:
        header = f.readline()
        text = f.read()
    names = [name.strip().strip('"') for name in header.rstrip("\r\n").split(",")]
    if ",," in text or ",\n" in text or ",\r" in text or "\n," in text or text.startswith(","):
        text = _EMPTY_FIELD.sub("nan", text)
    cols = [i for i, name in enumerate(names) if name != key]
    if key is not None and len(cols) == len(names):
        raise ValueError(f"{path}: no column named {key!r} in {names}")
    values = np.loadtxt(io.StringIO(text), delimiter=",", usecols=cols, ndmin=2,
                        dtype=np.float64)
    keys = None
    if key is not None:
        keys = np.loadtxt(io.StringIO(text), delimiter=",", usecols=names.index(key),
                          dtype=str, ndmin=1)
    return [names[i] for i in cols], keys, values


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
