"""Per-row code on one rank's rows of a data mesh.

Under a mesh (:mod:`bayesgm_torch.parallel`) every rank holds a contiguous
block of the ``n`` rows (data, latent table, MCMC chains) and steps the
same model generator as every other rank.  Inside :func:`split` the
port's per-row code behaves as if it saw all ``n`` rows:

- :func:`draw` makes a per-row random draw at the global row count on
  every rank and keeps this rank's block, so every rank consumes the
  generator as a one-rank run does and world ``W`` draws what world 1
  draws (the JAX package's global random arrays, whatever the sharding);
- :func:`mean` and :func:`sum_rows` reduce over the rows of every rank
  (:func:`partial_mean` and :func:`total` split :func:`mean` in two, to
  all-reduce a ring of per-step means once where it is read);
- :func:`gather` returns all ``n`` rows on every rank (the batch-statistic
  BatchNorm of the MNIST nets, whose rows are coupled).

Outside :func:`split` each function is the one-device operation it
replaces, unchanged.  ``rows`` is a :class:`bayesgm_torch.parallel.RowSplit`.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

_ACTIVE = contextvars.ContextVar("bayesgm_torch_rows", default=None)


@contextlib.contextmanager
def split(rows):
    """Run the block with ``rows`` (a ``RowSplit``, or None for no split)."""
    token = _ACTIVE.set(rows)
    try:
        yield rows
    finally:
        _ACTIVE.reset(token)


def current():
    """The active ``RowSplit``, or None."""
    return _ACTIVE.get()


def draw(fn, shape, axis: int = 0):
    """``fn(shape)``, a per-row random draw whose rows lie on ``axis``.

    Inside :func:`split` the local row count ``shape[axis]`` must be this
    rank's; the draw is made at the global count and this rank's block is
    returned."""
    rows = current()
    shape = tuple(int(s) for s in shape)
    if rows is None:
        return fn(shape)
    axis %= len(shape)
    if shape[axis] != rows.local:
        raise ValueError(f"per-row draw of shape {shape}: axis {axis} holds {shape[axis]} rows, "
                         f"this rank holds {rows.local}")
    full = fn(shape[:axis] + (rows.n,) + shape[axis + 1:])
    return full.narrow(axis, rows.lo, rows.local)


def mean(t, dim=None):
    """``t.mean(dim)`` with the rows on ``dim`` (``dim=None``: every entry,
    the rows on axis 0); inside :func:`split` the mean over every rank's
    rows: the local sum, all-reduced, over the global count."""
    rows = current()
    if rows is None:
        return t.mean() if dim is None else t.mean(dim)
    if dim is None:
        count = rows.n * math.prod(t.shape[1:])
        return rows.all_sum(t.sum()) / count
    return rows.all_sum(t.sum(dim)) / rows.n


def partial_mean(t):
    """``t.mean()`` over every entry (the rows on axis 0); inside
    :func:`split` this rank's part of the mean over every rank's rows (its
    sum over the global count), which :func:`total` completes: deferring
    the all-reduce to where the mean is read."""
    rows = current()
    if rows is None:
        return t.mean()
    return t.sum() / (rows.n * math.prod(t.shape[1:]))


def total(t):
    """``t`` summed over the ranks inside :func:`split` (``t`` itself
    outside): completes :func:`partial_mean`."""
    rows = current()
    return t if rows is None else rows.all_sum(t)


def sum_rows(t, dim: int = 0):
    """``t.sum(dim)`` over the rows on ``dim``; inside :func:`split` over
    every rank's rows."""
    rows = current()
    s = t.sum(dim)
    return s if rows is None else rows.all_sum(s)


def gather(t, axis: int = 0):
    """``t`` with the rows of every rank on ``axis`` (``t`` itself outside
    :func:`split`); differentiable, the gradient of each rank's rows summed
    over the ranks."""
    rows = current()
    return t if rows is None else rows.gather(t, axis)
