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
  reads a model the port trained;
- :func:`net_from_numpy` / :func:`net_to_numpy` carry one net (such as the
  identifiable model's prior net) both ways, and :func:`flat_weight_samples`
  takes JAX ``FullMCMCCausalBGM``'s flat weight samples;
- BGM's decoders (``VariationalMLP``, ``FlipoutVariationalMLP``) and the
  low-rank nets (``LowRankVariationalMLP``, ``FlipoutLowRankVariationalMLP``:
  ``norm``, ``layers``, ``mean``, ``var``, ``lowrank``) go both ways as
  their parameter trees; their running statistics are JAX's
  ``g_state = {"norm": {"mean", "var"}}`` (:func:`bn_state_to_numpy`,
  :func:`bn_state_from_numpy`);
- MNISTBGM's conv nets (``ops/conv.py``: encoder, plain or flipout
  generator, image critic) go both ways as their parameter trees, each
  4-D kernel carried between JAX's HWIO and the port's layout
  (:func:`~bayesgm_torch.ops.conv.kernel_to_hwio`; a transposed
  convolution's kernel is flipped there, once).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from bayesgm_torch.ops import conv
from bayesgm_torch.ops.nn import (
    MLP,
    Critic,
    FlipoutLowRankVariationalMLP,
    FlipoutMLP,
    FlipoutVariationalMLP,
    LowRankVariationalMLP,
    VariationalMLP,
    _VariationalBase,
)

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


def _is_variational(tree) -> bool:
    return isinstance(tree, dict) and {"norm", "mean", "var"} <= set(tree)


def variational_from_numpy(tree):
    """One ``VariationalMLP`` from ``{"norm": {gamma, beta}, "layers":
    [{w, b}], "mean": {w, b}, "var": {w, b}}``, or a ``FlipoutVariationalMLP``
    where the layers and heads hold ``loc``, ``rho`` and ``b``; with a
    ``"lowrank"`` head, the ``LowRankVariationalMLP`` or
    ``FlipoutLowRankVariationalMLP`` of its rank.  The running statistics
    keep their initial values (see :func:`bn_state_from_numpy`)."""
    flipout = "loc" in tree["mean"]
    kernel = "loc" if flipout else "w"
    layers = tree.get("layers", [])
    dims = ([np.shape(tree["norm"]["gamma"])[0]] + [np.shape(l[kernel])[1] for l in layers]
            + [np.shape(tree["mean"][kernel])[1]])
    if "lowrank" in tree:
        rank = np.shape(tree["lowrank"][kernel])[1] // dims[-1]
        cls = FlipoutLowRankVariationalMLP if flipout else LowRankVariationalMLP
        net = cls(dims[0], dims[-1], dims[1:-1], rank=rank)
    else:
        net = (FlipoutVariationalMLP if flipout else VariationalMLP)(dims[0], dims[-1],
                                                                     dims[1:-1])
    with torch.no_grad():
        for name, param in net.named_parameters():
            node = tree
            for part in _param_path(net, name):
                node = node[part]
            param.copy_(torch.tensor(np.asarray(node), dtype=torch.float32))
    return net


def bn_state_to_numpy(net: _VariationalBase) -> dict:
    """A decoder's running statistics as JAX's ``g_state``."""
    return {"norm": {"mean": net.bn_mean.detach().cpu().numpy(),
                     "var": net.bn_var.detach().cpu().numpy()}}


def bn_state_from_numpy(tree, device=None) -> tuple:
    """``(mean, var)`` float32 tensors from JAX's ``g_state``."""
    return tuple(torch.as_tensor(np.asarray(tree["norm"][k]), dtype=torch.float32, device=device)
                 for k in ("mean", "var"))


_CONV_NETS = {  # the JAX tree's keys of each MNIST net
    frozenset({"c1", "bn1", "c2", "bn2", "c3", "bn3", "d1", "d2"}): "encoder",
    frozenset({"fc", "u1", "bn1", "u2", "bn2", "c3", "bn3", "mean", "var"}): "generator",
    frozenset({"c1", "c2", "c3", "d1", "logit"}): "discriminator",
}


def conv_net_from_numpy(tree):
    """One ``MNISTEncoder``, ``MNISTGenerator`` (plain, or flipout where its
    layers hold ``loc`` and ``rho``) or ``MNISTDiscriminator`` from its JAX
    pytree, its widths read from the kernels' shapes; None for a tree of
    another kind."""
    kind = _CONV_NETS.get(frozenset(tree)) if isinstance(tree, dict) else None
    if kind == "encoder":
        net = conv.MNISTEncoder(np.shape(tree["d2"]["w"])[1], np.shape(tree["c1"]["w"])[3])
    elif kind == "generator":
        z_dim, width = np.shape(tree["fc"]["w"])
        net = conv.MNISTGenerator(z_dim, width // 196, use_bnn="rho" in tree["u1"])
    elif kind == "discriminator":
        net = conv.MNISTDiscriminator(np.shape(tree["c1"]["w"])[3])
    else:
        return None
    with torch.no_grad():
        for name, param in net.named_parameters():
            node = tree
            for part in _param_path(net, name):
                node = node[part]
            param.copy_(torch.as_tensor(_from_jax_layout(net, name, node), dtype=torch.float32))
    return net


def _to_jax_layout(net, name: str, a: np.ndarray) -> np.ndarray:
    """The JAX layout of the value ``a`` of parameter ``name`` (a conv
    kernel's HWIO; every other parameter as it is)."""
    if isinstance(net, conv.ConvNet) and a.ndim == 4:
        return conv.kernel_to_hwio(a, net.get_submodule(name.rpartition(".")[0]).transpose)
    return a


def _from_jax_layout(net, name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if isinstance(net, conv.ConvNet) and a.ndim == 4:
        return conv.kernel_from_hwio(a, net.get_submodule(name.rpartition(".")[0]).transpose)
    return a


def net_from_numpy(tree):
    """One ``VariationalMLP``, ``FlipoutVariationalMLP``, low-rank net, ``FlipoutMLP``,
    ``Critic``, ``MLP`` or MNIST conv net from its JAX pytree, or None for a
    tree of another kind."""
    conv_net = conv_net_from_numpy(tree)
    if conv_net is not None:
        return conv_net
    if _is_variational(tree):
        return variational_from_numpy(tree)
    if _is_flipout_net(tree):
        return flipout_mlp_from_numpy(tree)
    if _is_critic(tree):
        return critic_from_numpy(tree)
    if _is_mlp(tree):
        return mlp_from_numpy(tree)
    return None


def nets_from_numpy(tree) -> dict:
    """``{name: net}`` for every entry of ``tree`` that :func:`net_from_numpy`
    reads (nets of other kinds are left out)."""
    nets = {name: net_from_numpy(sub) for name, sub in tree.items()}
    return {name: net for name, net in nets.items() if net is not None}


def flat_weight_samples(samples, net: MLP) -> np.ndarray:
    """A stack of flat weight samples ``(N, D)`` of the plain MLP ``net``, as
    JAX ``FullMCMCCausalBGM`` stores them (``ravel_pytree`` order), for the
    port: the port's flat order is JAX's (``ops.nn.flatten_params``), so the
    carry-across is the identity on the values; it checks the width and
    returns float32."""
    samples = np.asarray(samples, np.float32)
    width = sum(p.numel() for p in net.parameters())
    if samples.ndim != 2 or samples.shape[1] != width:
        raise ValueError(f"flat weight samples of shape {samples.shape} for a net of "
                         f"{width} weights (expected (N, {width}))")
    return samples


def net_to_numpy(net) -> dict:
    """The JAX pytree of one port net (inverse of the readers above)."""
    a = lambda t: t.detach().cpu().numpy().astype(np.float32)
    if isinstance(net, (_VariationalBase, conv.ConvNet)):
        return params_to_tree(net, [p for _, p in net.named_parameters()])
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


def _param_path(net, name: str) -> list:
    """The JAX pytree path, below the net, of the port parameter ``name``
    (a ``named_parameters`` name such as ``loc.2`` or ``bn_gamma.0``)."""
    if isinstance(net, conv.ConvNet):  # named by its JAX path: "c1.w", "bn1.gamma"
        return name.split(".")
    field, _, index = name.partition(".")
    if isinstance(net, (FlipoutMLP, _VariationalBase)) and field in ("gamma", "beta"):
        return ["norm", field]
    if isinstance(net, _VariationalBase) and not index:  # a head: mean_w, var_rho, ...
        return field.split("_", 1)
    if isinstance(net, Critic) and field in ("bn_gamma", "bn_beta"):
        return ["bn", int(index), field[3:]]
    if index:
        return ["layers", int(index), field]
    raise TypeError(f"no JAX path for parameter {name!r} of {type(net).__name__}")


def params_to_tree(nets, values):
    """Arrange ``values`` (one per parameter, in ``parameters()`` order) as
    the JAX pytree of ``nets``: a net's tree for one net, ``{name: net
    tree}`` for a dict of nets (taken in the dict's order).  Each value
    becomes a numpy array."""
    named = nets if isinstance(nets, dict) else {None: nets}
    values = iter(values)
    root: dict = {}
    for k, net in named.items():
        node0 = root.setdefault(k, {})
        for name, _ in net.named_parameters():
            node = node0
            *parents, leaf = _param_path(net, name)
            for part in parents:
                node = node.setdefault(part, {})
            v = next(values)
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            node[leaf] = _to_jax_layout(net, name, v)
    root = _listify(root)
    return root if isinstance(nets, dict) else root[None]


def tree_to_params(nets, tree, device) -> list:
    """The inverse of :func:`params_to_tree`: the float32 tensors of
    ``tree`` on ``device``, in the parameters' order."""
    named = nets if isinstance(nets, dict) else {None: nets}
    out = []
    for k, net in named.items():
        for name, _ in net.named_parameters():
            node = tree[k] if isinstance(nets, dict) else tree
            for part in _param_path(net, name):
                node = node[part]
            out.append(torch.as_tensor(_from_jax_layout(net, name, node), dtype=torch.float32,
                                       device=device))
    return out


def adam_to_jax(state, nets):
    """A port ``AdamState`` (moment lists in the parameters' order of
    ``nets``, a net or a dict of nets) in JAX's form: ``AdamState(m=tree,
    v=tree, t=int32)``, the trees shaped as :func:`params_to_tree` shapes
    them."""
    return type(state)(m=params_to_tree(nets, state.m), v=params_to_tree(nets, state.v),
                       t=np.asarray(state.t, np.int32))


def adam_from_jax(tree, nets, device):
    """The port's ``AdamState`` from JAX's form (see :func:`adam_to_jax`)."""
    return type(tree)(m=tree_to_params(nets, tree.m, device),
                      v=tree_to_params(nets, tree.v, device), t=int(tree.t))


def table_adam_to_jax(state):
    """A port ``TableAdamState`` with numpy moments and an int32 step."""
    return type(state)(m=state.m.detach().cpu().numpy(), v=state.v.detach().cpu().numpy(),
                       t=np.asarray(state.t, np.int32))


def table_adam_from_jax(tree, device):
    return type(tree)(m=torch.as_tensor(tree.m, device=device),
                      v=torch.as_tensor(tree.v, device=device), t=int(tree.t))


def save_npz(path: str, nets: dict, data_z=None, g_state=None) -> str:
    """Write ``{"nets": nets, "g_state": g_state, "data_z": data_z}`` (the
    last two where given; ``g_state`` in JAX's form, BGM's bundle) as JAX
    ``save_weights`` does: one ``.npz`` keyed by ``keystr`` paths, renamed
    into place."""
    tree = {"nets": nets_to_numpy(nets)}
    if g_state is not None:
        tree["g_state"] = g_state
    if data_z is not None:
        tree["data_z"] = (data_z.detach().cpu().numpy() if torch.is_tensor(data_z)
                          else np.asarray(data_z, np.float32))
    from bayesgm_torch.utils.checkpoint import save_pytree

    return save_pytree(path, tree)


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
    """``{"nets": {name: net}, **other arrays}`` from a JAX ``save_weights``
    file of CausalBGM or BGM, or the port's of MNISTBGM (``data_z`` stays a
    numpy array, BGM's ``g_state`` a nested dict of them)."""
    tree = npz_tree(path)
    out = {k: v for k, v in tree.items() if k != "nets"}
    out["nets"] = nets_from_numpy(tree["nets"])
    return out
