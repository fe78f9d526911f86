"""Read the checkpoints the JAX package writes, with numpy alone.

The JAX package saves one full-state bundle per checkpoint as
``{ckpt_dir}/ckpt-{step}.npz``: nets, optimizer states, the latent table and
its moments, the PRNG key and counters, keyed by ``jax.tree_util.keystr``
paths.  This module is the port's copy of the parts of
``bayesgm_tpu/utils/checkpoint.py`` that need no JAX: finding the latest
file and reading its ``['nets']`` group.  Writing checkpoints and restoring
the rest of the state are not ported.
"""

from __future__ import annotations

import os
import re

import numpy as np

from bayesgm_torch import bridge

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(f)))


def latest_checkpoint(ckpt_dir: str):
    """Path to the newest ``ckpt-*.npz`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"ckpt-{steps[-1]}.npz")


def checkpoint_step(path: str) -> int:
    """The step number encoded in a ``ckpt-{step}.npz`` filename."""
    m = _CKPT_RE.match(os.path.basename(path))
    if m is None:
        raise ValueError(f"Not a checkpoint filename: {path}")
    return int(m.group(1))


def has_group(path: str, name: str) -> bool:
    """Whether the stored file holds any leaf under top-level key ``name``."""
    prefix = f"['{name}']"
    with np.load(path) as data:
        return any(k == prefix or k.startswith(prefix) for k in data.files)


def read_nets(path: str) -> dict:
    """The ``['nets']`` subtree of a checkpoint as nested numpy, in the form
    :func:`bayesgm_torch.bridge.nets_from_numpy` takes."""
    tree = bridge.npz_tree(path)
    if "nets" not in tree:
        raise KeyError(f"Checkpoint {path} has no ['nets'] group")
    return tree["nets"]
