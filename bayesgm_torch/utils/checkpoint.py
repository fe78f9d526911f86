"""Pytree checkpoints in the JAX package's format, with numpy alone.

Both packages save one bundle per checkpoint as ``{ckpt_dir}/ckpt-{step}.npz``,
written to a ``.tmp`` file and renamed into place, keeping the newest
``max_to_keep``.  Its keys are ``jax.tree_util.keystr`` paths:
``['nets']['g']['layers'][0]['loc']`` for a dict key or a list index,
``['opt_d'].m[...]`` for a NamedTuple field.  This module is the port's copy
of ``bayesgm_tpu/utils/checkpoint.py``: a tree here is nested dicts, lists,
tuples and NamedTuples whose leaves are numpy arrays, torch tensors or
Python numbers.

Restores are template-driven, as in the JAX package: :func:`restore_checkpoint`
fills the leaves of a caller's tree from the stored arrays (at the template
leaf's shape and dtype) and raises ``KeyError`` on a leaf the file lacks, so
a subset template restores fine against a larger file.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from bayesgm_torch import bridge

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _as_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten(tree, prefix: str = "") -> dict:
    """``{keystr path: numpy array}`` for every leaf of ``tree``."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, sub in node.items():
                walk(sub, f"{path}['{k}']")
        elif _is_namedtuple(node):
            for name, sub in zip(node._fields, node):
                walk(sub, f"{path}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, f"{path}[{i}]")
        else:
            out[path] = _as_numpy(node)

    walk(tree, prefix)
    return out


def save_pytree(path: str, tree) -> str:
    """Save ``tree`` to ``path`` (.npz), atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, step: int, tree, max_to_keep: int = 5) -> str:
    """Save ``tree`` as ``{ckpt_dir}/ckpt-{step}.npz`` (atomic rename), then
    delete all but the newest ``max_to_keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = save_pytree(os.path.join(ckpt_dir, f"ckpt-{step}.npz"), tree)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, f"ckpt-{old}.npz"))
    return path


def restore_checkpoint(path: str, template):
    """``template`` with every leaf replaced by the stored array of the same
    path, reshaped and cast to the leaf's shape and dtype (numpy arrays; the
    containers keep their types).  Raises ``KeyError`` on a missing leaf."""
    with np.load(path) as data:

        def fill(node, key):
            if isinstance(node, dict):
                return {k: fill(sub, f"{key}['{k}']") for k, sub in node.items()}
            if _is_namedtuple(node):
                return type(node)(*(fill(sub, f"{key}.{name}")
                                    for name, sub in zip(node._fields, node)))
            if isinstance(node, (list, tuple)):
                return type(node)(fill(sub, f"{key}[{i}]") for i, sub in enumerate(node))
            if key not in data.files:
                raise KeyError(f"Checkpoint {path} missing leaf {key}")
            like = _as_numpy(node)
            return np.asarray(data[key]).reshape(like.shape).astype(like.dtype)

        return fill(template, "")


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
