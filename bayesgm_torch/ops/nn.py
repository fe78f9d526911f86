"""Flipout Bayesian MLP and the WGAN critic (port of the flipout subset and
the critic of ``bayesgm_tpu/ops/nn.py``).

Conventions kept from the JAX package for numerical parity:

- LeakyReLU slope 0.2 between hidden layers, linear final layer;
- dense layers of the critic: Glorot-uniform kernel, zero bias (Keras
  ``Dense``); the critic's hidden norms are frozen BatchNorm affines and its
  activation is tanh;
- the input norm is inference-mode BatchNorm with frozen (0, 1) statistics,
  i.e. the affine ``x * gamma * (1 + BN_EPS)^-1/2 + beta``;
- mean-field Gaussian kernel posterior ``N(loc, softplus(rho)^2)`` with a
  deterministic bias, initialised ``loc ~ 0.1 N(0,1)``,
  ``rho ~ -3 + 0.1 N(0,1)``, ``b = 0`` (the ``tfp.layers.DenseFlipout``
  family).

Randomness comes from an explicit ``torch.Generator``.  Every apply accepts
inputs with leading batch axes ``(..., n, in)``: each leading index gets its
own weight-noise draw (the effect collector's per-grid-point draws).  All
parameters are trainable ``nn.Parameter``s; gradients flow through every
apply.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from bayesgm_torch.ops.distributions import softplus

LEAKY_SLOPE = 0.2
BN_EPS = 1e-3


def leaky_relu(x):
    return torch.where(x > 0, x, LEAKY_SLOPE * x)


def frozen_batchnorm_apply(gamma, beta, x):
    """Inference-mode BatchNorm with frozen (0, 1) moving statistics."""
    return x * gamma * (1.0 + BN_EPS) ** -0.5 + beta


def _glorot_dense(in_dim: int, out_dim: int, generator):
    """``(w, b)``: Glorot-uniform kernel and zero bias (Keras Dense defaults)."""
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = (torch.rand((in_dim, out_dim), generator=generator) * 2.0 - 1.0) * limit
    return nn.Parameter(w), nn.Parameter(torch.zeros(out_dim))


def dense_apply(w, b, x):
    return x @ w + b


class Critic(nn.Module):
    """The WGAN critic ``dims = [in, *hidden, 1]``: per hidden layer dense,
    frozen-BN affine (trainable ``bn_gamma[i]``/``bn_beta[i]``), tanh; a
    linear last layer."""

    def __init__(self, input_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden), 1]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w, b = _glorot_dense(d_in, d_out, generator)
            self.w.append(w)
            self.b.append(b)
        self.bn_gamma = nn.ParameterList([nn.Parameter(torch.ones(h)) for h in dims[1:-1]])
        self.bn_beta = nn.ParameterList([nn.Parameter(torch.zeros(h)) for h in dims[1:-1]])

    @property
    def dims(self) -> list:
        return [self.w[0].shape[0]] + [w.shape[1] for w in self.w]

    def forward(self, x):
        return critic_apply(self, x)


def critic_apply(net: Critic, x):
    """tanh critic with frozen-BN affines, scalar logit out ``(..., 1)``."""
    n_hidden = len(net.w) - 1
    for i in range(n_hidden):
        x = dense_apply(net.w[i], net.b[i], x)
        x = torch.tanh(frozen_batchnorm_apply(net.bn_gamma[i], net.bn_beta[i], x))
    return dense_apply(net.w[-1], net.b[-1], x)


class FlipoutMLP(nn.Module):
    """``[input norm, flipout dense x L]`` with ``dims = [in, *hidden, out]``.

    Parameters are ``gamma``/``beta`` (the input norm) and per layer
    ``loc[i]``, ``rho[i]`` (both ``(in_i, out_i)``) and ``b[i]``
    (``(out_i,)``).  Weights are drawn on the CPU from ``generator`` so the
    same seed gives the same net on every device.
    """

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden), int(output_dim)]
        self.gamma = nn.Parameter(torch.ones(dims[0]))
        self.beta = nn.Parameter(torch.zeros(dims[0]))
        self.loc = nn.ParameterList()
        self.rho = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            self.loc.append(nn.Parameter(
                0.1 * torch.randn((d_in, d_out), generator=generator)))
            self.rho.append(nn.Parameter(
                -3.0 + 0.1 * torch.randn((d_in, d_out), generator=generator)))
            self.b.append(nn.Parameter(torch.zeros(d_out)))

    @property
    def dims(self) -> list:
        return [self.loc[0].shape[0]] + [loc.shape[1] for loc in self.loc]

    def layers(self) -> list:
        """``[(loc, rho, b), ...]`` per layer."""
        return list(zip(self.loc, self.rho, self.b))

    def forward(self, x, generator: torch.Generator):
        return flipout_mlp_apply(self, x, generator)


def _flipout_dense_pre(layer, x, eps, r_in, r_out):
    """Flipout dense with the randomness passed in:
    ``x @ loc + ((x * r_in) @ (softplus(rho) * eps)) * r_out + b``."""
    loc, rho, b = layer
    scale = softplus(rho)
    mean_out = x @ loc
    pert_out = ((x * r_in) @ (scale * eps)) * r_out
    return mean_out + pert_out + b


def _rademacher(shape, generator, device):
    return torch.randint(0, 2, shape, generator=generator, device=device,
                         dtype=torch.int32).to(torch.float32) * 2.0 - 1.0


def _fused_flipout_draws(layers, x_shape, generator):
    """One eps draw and one sign draw for a whole flipout-MLP call.

    ``x_shape`` is ``(..., n, in)``: each leading index gets its own eps
    (shared across its ``n`` rows, the DenseFlipout convention) and every row
    its own signs.  Returns ``(eps_list, r_in_list, r_out_list)``.
    """
    lead, batch = tuple(x_shape[:-2]), int(x_shape[-2])
    device = layers[0][0].device
    dims = [tuple(loc.shape) for loc, _, _ in layers]
    eps_flat = torch.randn(lead + (sum(i * o for i, o in dims),),
                           generator=generator, device=device)
    signs = _rademacher(lead + (batch, sum(i + o for i, o in dims)),
                        generator, device)
    eps_list, r_in_list, r_out_list = [], [], []
    eo = so = 0
    for i, o in dims:
        eps_list.append(eps_flat[..., eo:eo + i * o].reshape(lead + (i, o)))
        eo += i * o
        r_in_list.append(signs[..., so:so + i])
        r_out_list.append(signs[..., so + i:so + i + o])
        so += i + o
    return eps_list, r_in_list, r_out_list


def flipout_mlp_apply(net: FlipoutMLP, x, generator: torch.Generator, draws=None):
    """Flipout forward with a fresh draw from ``generator``, or with
    ``draws`` (an earlier ``_fused_flipout_draws`` result, which broadcasts
    against extra leading axes of ``x``: every leading index then sees the
    same eps and signs)."""
    x = frozen_batchnorm_apply(net.gamma, net.beta, x)
    layers = net.layers()
    if draws is None:
        draws = _fused_flipout_draws(layers, x.shape, generator)
    eps, r_in, r_out = draws
    for j, layer in enumerate(layers[:-1]):
        x = leaky_relu(_flipout_dense_pre(layer, x, eps[j], r_in[j], r_out[j]))
    return _flipout_dense_pre(layers[-1], x, eps[-1], r_in[-1], r_out[-1])


def flipout_dense_kl(layer, prior_scale: float = 1.0,
                     bias_prior_scale: float | None = None):
    """KL(q || p) for the kernel posterior N(loc, scale^2) vs prior N(0, s^2);
    with a bias prior, adds the cross-entropy -log N(b; 0, s^2)."""
    loc, rho, b = layer
    var_ratio = (softplus(rho) / prior_scale) ** 2
    kl = 0.5 * torch.sum(var_ratio + (loc / prior_scale) ** 2 - 1.0 - torch.log(var_ratio))
    if bias_prior_scale is not None:
        s2 = bias_prior_scale**2
        kl = kl + 0.5 * torch.sum(b**2 / s2 + math.log(2 * math.pi * s2))
    return kl


def flipout_mlp_kl(net: FlipoutMLP, prior_scale: float = 1.0,
                   bias_prior_scale: float | None = None):
    return sum(flipout_dense_kl(layer, prior_scale, bias_prior_scale)
               for layer in net.layers())


def flipout_mlp_mean_apply(net: FlipoutMLP, x):
    """Deterministic forward through the posterior means (no weight noise)."""
    x = frozen_batchnorm_apply(net.gamma, net.beta, x)
    layers = net.layers()
    for loc, _, b in layers[:-1]:
        x = leaky_relu(x @ loc + b)
    loc, _, b = layers[-1]
    return x @ loc + b
