"""Turn the JAX package's parameters into the port's.

Two entry points:

- :func:`nets_from_numpy` takes a nested dict/list of numpy arrays shaped
  like ``bayesgm_tpu`` ``CausalBGM.nets`` and returns a ``FlipoutMLP`` per
  flipout-shaped net;
- :func:`load_npz` reads the ``.npz`` that ``CausalBGM.save_weights`` writes.
  Its keys are ``jax.tree_util.keystr`` paths such as
  ``"['nets']['g']['layers'][0]['loc']"``; they are parsed with numpy and
  the standard library alone.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from bayesgm_torch.ops.nn import FlipoutMLP

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _is_flipout_net(tree) -> bool:
    return (isinstance(tree, dict) and "norm" in tree and "layers" in tree
            and all("loc" in layer for layer in tree["layers"]))


def flipout_mlp_from_numpy(tree) -> FlipoutMLP:
    """One ``FlipoutMLP`` from ``{"norm": {gamma, beta}, "layers": [{loc, rho, b}]}``."""
    layers = tree["layers"]
    dims = [np.shape(layers[0]["loc"])[0]] + [np.shape(l["loc"])[1] for l in layers]
    net = FlipoutMLP(dims[0], dims[-1], dims[1:-1])
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    with torch.no_grad():
        net.gamma.copy_(as_t(tree["norm"]["gamma"]))
        net.beta.copy_(as_t(tree["norm"]["beta"]))
        for i, layer in enumerate(layers):
            for name in ("loc", "rho", "b"):
                getattr(net, name)[i].copy_(as_t(layer[name]))
    return net


def nets_from_numpy(tree) -> dict:
    """``{name: FlipoutMLP}`` for every flipout-shaped entry of ``tree``
    (nets of other kinds, such as the plain critic ``dz``, are left out)."""
    return {name: flipout_mlp_from_numpy(sub) for name, sub in tree.items()
            if _is_flipout_net(sub)}


def _parse_key(key: str) -> list:
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unparseable pytree key {key!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"unparseable pytree key {key!r}")
    return parts


def _listify(node):
    """Turn dicts whose keys are all ints 0..k-1 into lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sparse list indices {sorted(node)}")
        return [node[i] for i in range(len(node))]
    return node


def npz_tree(path: str) -> dict:
    """The nested numpy tree stored in a ``save_weights`` ``.npz``."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _parse_key(key)
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(data[key])
    return _listify(root)


def load_npz(path: str) -> dict:
    """``{"nets": {name: FlipoutMLP}, **other arrays}`` from a JAX
    ``CausalBGM.save_weights`` file (``data_z`` stays a numpy array)."""
    tree = npz_tree(path)
    out = {k: v for k, v in tree.items() if k != "nets"}
    out["nets"] = nets_from_numpy(tree["nets"])
    return out
