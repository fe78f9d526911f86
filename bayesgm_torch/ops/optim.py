"""Adam in the ``tf.keras.optimizers.Adam`` form (port of
``bayesgm_tpu/ops/optim.py``).

- :func:`adam_update`: dense Adam over a list of parameter tensors, with
  ``b2 = 0.99``, ``eps = 1e-7`` outside the square root and the bias
  correction folded into the rate, ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``.
  ``torch.optim.Adam`` puts eps inside the corrected denominator and
  defaults ``b2`` to 0.999, so it is not used.
- :func:`table_adam_update_rows`: row-sparse Adam on the per-sample latent
  table: the moments of all rows decay every step, only the batch rows get
  the gradient term and the parameter update, and the bias correction uses
  the global step (Keras' sparse-Adam convention).

Unlike the JAX functions these update in place: the parameters, the latent
table and the moment tensors are overwritten (the step count lives in the
returned state), which saves a copy of every tensor per step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EPS = 1e-7  # Keras Adam default epsilon


class AdamState(NamedTuple):
    m: list  # one tensor per parameter
    v: list
    t: int   # step count


def adam_init(params) -> AdamState:
    params = list(params)
    return AdamState(m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params], t=0)


def _lr_t(lr: float, t: int, b1: float, b2: float) -> float:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32, as JAX evaluates it."""
    f = np.float32
    tf_ = f(t)
    return float(f(lr) * np.sqrt(f(1) - f(b2) ** tf_) / (f(1) - f(b1) ** tf_))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, lr: float, b1: float = 0.9,
                b2: float = 0.99) -> AdamState:
    """One Adam step: ``params`` (a list of tensors) and the moments are
    updated in place; returns the state with the step count advanced."""
    params, grads = list(params), list(grads)
    t = state.t + 1
    torch._foreach_mul_(state.m, b1)
    torch._foreach_add_(state.m, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(state.v, b2)
    torch._foreach_add_(state.v, torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))
    denom = torch._foreach_add(torch._foreach_sqrt(state.v), EPS)
    torch._foreach_add_(params, torch._foreach_div(state.m, denom), alpha=-_lr_t(lr, t, b1, b2))
    return AdamState(m=state.m, v=state.v, t=t)


class TableAdamState(NamedTuple):
    m: torch.Tensor  # (n, d)
    v: torch.Tensor  # (n, d)
    t: int           # global step (Keras sparse-Adam convention)


def table_adam_init(table: torch.Tensor) -> TableAdamState:
    return TableAdamState(m=torch.zeros_like(table), v=torch.zeros_like(table), t=0)


@torch.no_grad()
def table_adam_update_rows(grad_rows, idx, state: TableAdamState, table, lr: float,
                           b1: float = 0.9, b2: float = 0.99) -> TableAdamState:
    """Adam update of ``table[idx]`` from ``grad_rows`` ``(len(idx), d)``.

    Every row's moments decay (``m <- b1 m``, ``v <- b2 v``); the ``(1 - b)``
    gradient terms are added at ``idx`` (repeated indices add up, as JAX's
    ``.at[].add``) and only ``table[idx]`` moves.  ``table`` and the moments
    are updated in place."""
    t = state.t + 1
    m, v = state.m, state.v
    m.mul_(b1).index_add_(0, idx, (1 - b1) * grad_rows)
    v.mul_(b2).index_add_(0, idx, (1 - b2) * grad_rows * grad_rows)
    new_rows = table[idx] - _lr_t(lr, t, b1, b2) * m[idx] / (torch.sqrt(v[idx]) + EPS)
    table.index_copy_(0, idx, new_rows)
    return TableAdamState(m=m, v=v, t=t)


def rows_at(idx, *tables):
    """The rows ``idx`` of each table, ``[t[idx] for t in tables]``; for a
    minibatch of a mesh (:class:`bayesgm_torch.parallel.mesh.MeshBatch`)
    the rows are assembled from every rank's tables."""
    if torch.is_tensor(idx):
        return [t[idx] for t in tables]
    return idx.take(*tables)


def table_adam_update_batch(grad_rows, idx, state: TableAdamState, table,
                            lr: float) -> TableAdamState:
    """:func:`table_adam_update_rows` for the minibatch ``idx`` (see
    :func:`rows_at`): under a mesh each rank steps its own rows of its
    table block (every row's moments decay, as on one device)."""
    if torch.is_tensor(idx):
        return table_adam_update_rows(grad_rows, idx, state, table, lr)
    return table_adam_update_rows(grad_rows.index_select(0, idx.pos), idx.local_idx, state,
                                  table, lr)


def lr_schedule_scale(decay, epoch: int, total_epochs: int) -> float:
    """Learning-rate scale at ``epoch`` of a ``total_epochs`` horizon:
    ``'cosine'`` (half cosine from 1 to 0), ``'linear'`` (1 down to a 0.05
    floor) or None/'' (constant 1), rounded to float32 as in JAX."""
    frac = epoch / max(1, total_epochs)
    if decay == "cosine":
        return float(np.float32(0.5 * (1.0 + math.cos(math.pi * min(frac, 1.0)))))
    if decay == "linear":
        return float(np.float32(max(1.0 - frac, 0.05)))
    return 1.0
