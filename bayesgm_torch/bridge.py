"""Carry parameters between the JAX package and the port, both ways.

- :func:`nets_from_numpy` takes a nested dict/list of numpy arrays shaped
  like ``bayesgm_tpu`` ``CausalBGM.nets`` and returns a ``FlipoutMLP`` per
  flipout-shaped net, a ``Critic`` per critic-shaped net and an ``MLP`` per
  plain net (``use_bnn=False``);
- :func:`load_npz` reads the ``.npz`` that ``CausalBGM.save_weights`` writes,
  and a full-state ``ckpt-*.npz`` of the JAX fit loop.  Its keys are
  ``jax.tree_util.keystr`` paths such as
  ``"['nets']['g']['layers'][0]['loc']"`` or ``"['opt_d'].m['bn'][0]['beta']"``
  (a NamedTuple field reads as a dict key); they are parsed with numpy and
  the standard library alone;
- :func:`nets_to_numpy` and :func:`save_npz` go the other way: they write
  the port's nets under the same keys, so JAX ``CausalBGM.load_weights``
  reads a model the port trained.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from bayesgm_torch.ops.nn import MLP, Critic, FlipoutMLP

# keystr parts: ['key'] (dict), [0] (list) and .name (a NamedTuple field,
# as in the Adam states .m, .v and .t of a JAX full-state checkpoint)
_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)")


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


def _is_critic(tree) -> bool:
    return (isinstance(tree, dict) and "bn" in tree and "layers" in tree
            and all("w" in layer for layer in tree["layers"]))


def critic_from_numpy(tree) -> Critic:
    """One ``Critic`` from ``{"layers": [{w, b}], "bn": [{gamma, beta}]}``."""
    layers = tree["layers"]
    dims = [np.shape(layers[0]["w"])[0]] + [np.shape(l["w"])[1] for l in layers]
    if dims[-1] != 1 or len(tree["bn"]) != len(layers) - 1:
        raise ValueError(f"not a critic: dims {dims}, {len(tree['bn'])} norms")
    net = Critic(dims[0], dims[1:-1])
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    with torch.no_grad():
        for i, layer in enumerate(layers):
            net.w[i].copy_(as_t(layer["w"]))
            net.b[i].copy_(as_t(layer["b"]))
        for i, bn in enumerate(tree["bn"]):
            net.bn_gamma[i].copy_(as_t(bn["gamma"]))
            net.bn_beta[i].copy_(as_t(bn["beta"]))
    return net


def _is_mlp(tree) -> bool:
    return (isinstance(tree, dict) and set(tree) == {"layers"}
            and all(set(layer) == {"w", "b"} for layer in tree["layers"]))


def mlp_from_numpy(tree) -> MLP:
    """One plain ``MLP`` from ``{"layers": [{w, b}]}``."""
    layers = tree["layers"]
    dims = [np.shape(layers[0]["w"])[0]] + [np.shape(l["w"])[1] for l in layers]
    net = MLP(dims[0], dims[-1], dims[1:-1])
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    with torch.no_grad():
        for i, layer in enumerate(layers):
            net.w[i].copy_(as_t(layer["w"]))
            net.b[i].copy_(as_t(layer["b"]))
    return net


def nets_from_numpy(tree) -> dict:
    """``{name: FlipoutMLP, Critic or MLP}`` for every flipout-, critic- or
    plain-MLP-shaped entry of ``tree`` (nets of other kinds are left out)."""
    nets = {}
    for name, sub in tree.items():
        if _is_flipout_net(sub):
            nets[name] = flipout_mlp_from_numpy(sub)
        elif _is_critic(sub):
            nets[name] = critic_from_numpy(sub)
        elif _is_mlp(sub):
            nets[name] = mlp_from_numpy(sub)
    return nets


def net_to_numpy(net) -> dict:
    """The JAX pytree of one port net (inverse of the two readers above)."""
    a = lambda t: t.detach().cpu().numpy().astype(np.float32)
    if isinstance(net, FlipoutMLP):
        return {"norm": {"gamma": a(net.gamma), "beta": a(net.beta)},
                "layers": [{"loc": a(loc), "rho": a(rho), "b": a(b)}
                           for loc, rho, b in net.layers()]}
    if isinstance(net, Critic):
        return {"layers": [{"w": a(w), "b": a(b)} for w, b in zip(net.w, net.b)],
                "bn": [{"gamma": a(g), "beta": a(bt)}
                       for g, bt in zip(net.bn_gamma, net.bn_beta)]}
    if isinstance(net, MLP):
        return {"layers": [{"w": a(w), "b": a(b)} for w, b in zip(net.w, net.b)]}
    raise TypeError(f"no JAX layout for {type(net).__name__}")


def nets_to_numpy(nets: dict) -> dict:
    return {name: net_to_numpy(net) for name, net in nets.items()}


def _flatten(node, prefix: str, out: dict):
    """``keystr`` paths of a dict/list tree: ``['a'][0]['b']``."""
    if isinstance(node, dict):
        for k, sub in node.items():
            _flatten(sub, f"{prefix}['{k}']", out)
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _flatten(sub, f"{prefix}[{i}]", out)
    else:
        out[prefix] = np.asarray(node)


def save_npz(path: str, nets: dict, data_z=None) -> str:
    """Write ``{"nets": nets, "data_z": data_z}`` as JAX ``save_weights``
    does: one ``.npz`` keyed by ``keystr`` paths, renamed into place."""
    tree = {"nets": nets_to_numpy(nets)}
    if data_z is not None:
        tree["data_z"] = (data_z.detach().cpu().numpy() if torch.is_tensor(data_z)
                          else np.asarray(data_z, np.float32))
    arrays: dict = {}
    _flatten(tree, "", arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _parse_key(key: str) -> list:
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unparseable pytree key {key!r}")
        if m.group(2) is not None:
            parts.append(int(m.group(2)))
        else:
            parts.append(m.group(1) if m.group(1) is not None else m.group(3))
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
    """``{"nets": {name: net}, **other arrays}`` from a JAX
    ``CausalBGM.save_weights`` file (``data_z`` stays a numpy array)."""
    tree = npz_tree(path)
    out = {k: v for k, v in tree.items() if k != "nets"}
    out["nets"] = nets_from_numpy(tree["nets"])
    return out
