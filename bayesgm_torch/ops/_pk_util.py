"""Host-side helpers for the log-posterior kernels (port of
``bayesgm_tpu/ops/_pk_util.py``): parameter flattening, layer dims and the
flipout kernels' per-evaluation weight-noise draw."""

from __future__ import annotations

import torch

from bayesgm_torch.ops.distributions import softplus
from bayesgm_torch.ops.nn import BN_EPS


def flatten_mlp_params(net) -> list:
    """``[w1, b1, w2, b2, ...]`` from a plain ``MLP``."""
    out = []
    for w, b in zip(net.w, net.b):
        out += [w, b]
    return [t.detach().contiguous() for t in out]


def mlp_layer_dims(net) -> list:
    """``[in, h1, ..., out]`` of a plain ``MLP``."""
    return list(net.dims)


def flatten_flipout_params(net) -> list:
    """``[gamma_eff, beta, (loc, sigma, b) per layer]`` from a ``FlipoutMLP``.

    ``sigma = softplus(rho)`` is precomputed so the kernel does only
    products; ``gamma_eff`` folds the frozen-BN ``(1 + BN_EPS)^-1/2``."""
    out = [net.gamma * (1.0 + BN_EPS) ** -0.5, net.beta]
    for loc, rho, b in net.layers():
        out += [loc, softplus(rho), b]
    return [t.detach().contiguous() for t in out]


def flipout_mlp_layer_dims(net) -> list:
    return list(net.dims)


def split_flipout_flat(flat):
    """``[gamma_eff, beta, (loc, sig, b) x L]`` ->
    ``([gamma_eff, beta, (loc, b) x L], [sig x L])``."""
    w = [flat[0], flat[1]]
    sigs = []
    for i in range((len(flat) - 2) // 3):
        w.append(flat[2 + 3 * i])
        sigs.append(flat[2 + 3 * i + 1])
        w.append(flat[2 + 3 * i + 2])
    return w, sigs


def flipout_step_perturbations(sigs, generator: torch.Generator, n_sets: int = 1,
                               antithetic: bool = False):
    """Fresh per-evaluation perturbation matrices ``P = sigma * eps``.

    ``sigs`` is the concatenated per-layer sigma list (g, then h, then f).
    One normal draw covers every layer; each P has a leading set axis of
    ``n_sets`` independent draws (the paired MH launch gives set 0 to the
    proposed half and set 1 to the current half).  ``antithetic=True``
    (``n_sets=2`` only) sets ``eps_1 = -eps_0``: each half's marginal law is
    unchanged, and the two sides of the accept ratio see negatively
    correlated weight noise."""
    sizes = [int(s.shape[0]) * int(s.shape[1]) for s in sigs]
    device = sigs[0].device
    if antithetic and n_sets == 2:
        half = torch.randn((1, sum(sizes)), generator=generator, device=device)
        flat = torch.cat([half, -half], dim=0)
    else:
        flat = torch.randn((n_sets, sum(sizes)), generator=generator, device=device)
    out, off = [], 0
    for s, sz in zip(sigs, sizes):
        out.append(s * flat[:, off:off + sz].reshape((n_sets,) + tuple(s.shape)))
        off += sz
    return out
