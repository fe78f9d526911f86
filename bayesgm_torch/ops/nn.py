"""Plain and flipout Bayesian MLPs, the WGAN critic, BGM's two variational
decoders, the two low-rank variational nets and a plain MLP's flat weights
(port of the plain MLP, the flipout subset, the critic, BatchNorm with
running statistics, the variational, flipout-variational and low-rank
(Woodbury) heads and the flat-weight helpers of ``bayesgm_tpu/ops/nn.py``).

Conventions kept from the JAX package for numerical parity:

- LeakyReLU slope 0.2 between hidden layers, linear final layer;
- dense layers of the plain MLP and of the critic: Glorot-uniform kernel,
  zero bias (Keras ``Dense``); the critic's hidden norms are frozen BatchNorm
  affines and its activation is tanh (the plain MLP has no norms, as
  CausalBGM builds it);
- the input norm is inference-mode BatchNorm with frozen (0, 1) statistics,
  i.e. the affine ``x * gamma * (1 + BN_EPS)^-1/2 + beta``;
- mean-field Gaussian kernel posterior ``N(loc, softplus(rho)^2)`` with a
  deterministic bias, initialised ``loc ~ 0.1 N(0,1)``,
  ``rho ~ -3 + 0.1 N(0,1)``, ``b = 0`` (the ``tfp.layers.DenseFlipout``
  family);
- the variational decoders' input norm is BatchNorm with running
  statistics (Keras ``BatchNormalization``: eps ``BN_EPS``, momentum
  ``BN_MOMENTUM``), kept as module buffers ``bn_mean``/``bn_var``; their
  variance head is ``softplus(raw) + 1e-6``;
- the low-rank nets' input norm runs frozen, as the flipout MLP's (the
  reference invokes it without a training flag); their heads give
  ``Sigma = diag(var) + U U^T`` with ``U`` of shape ``(batch, out, rank)``.

Randomness comes from an explicit ``torch.Generator``.  Every apply accepts
inputs with leading batch axes ``(..., n, in)``: each leading index gets its
own weight-noise draw (the effect collector's per-grid-point draws).  All
parameters are trainable ``nn.Parameter``s; gradients flow through every
apply.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops.distributions import softplus

LEAKY_SLOPE = 0.2
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
BVN_PRIOR_SCALE = 0.1  # the flipout-variational decoder's kernel and bias prior


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


class MLP(nn.Module):
    """Plain MLP ``dims = [in, *hidden, out]``: dense layers ``w[i]``,
    ``b[i]`` (Glorot-uniform kernel, zero bias), LeakyReLU between them, a
    linear last layer.  Weights are drawn on the CPU from ``generator``."""

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden), int(output_dim)]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w, b = _glorot_dense(d_in, d_out, generator)
            self.w.append(w)
            self.b.append(b)

    @property
    def dims(self) -> list:
        return [self.w[0].shape[0]] + [w.shape[1] for w in self.w]

    def forward(self, x):
        return mlp_apply(self, x)


def mlp_apply(net: MLP, x):
    """LeakyReLU MLP with a linear last layer (``net`` an :class:`MLP` or
    its :class:`MLPWeights`)."""
    n_hidden = len(net.w) - 1
    for i in range(n_hidden):
        x = leaky_relu(dense_apply(net.w[i], net.b[i], x))
    return dense_apply(net.w[-1], net.b[-1], x)


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


def _flipout_init(d_in: int, d_out: int, generator):
    """``(loc, rho, b)`` of one flipout layer: ``loc ~ 0.1 N(0,1)``, then
    ``rho ~ -3 + 0.1 N(0,1)``, ``b = 0``."""
    return (nn.Parameter(0.1 * torch.randn((d_in, d_out), generator=generator)),
            nn.Parameter(-3.0 + 0.1 * torch.randn((d_in, d_out), generator=generator)),
            nn.Parameter(torch.zeros(d_out)))


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
            loc, rho, b = _flipout_init(d_in, d_out, generator)
            self.loc.append(loc)
            self.rho.append(rho)
            self.b.append(b)

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
    its own signs (a per-row draw of :mod:`bayesgm_torch.ops.rows`).
    Returns ``(eps_list, r_in_list, r_out_list)``.
    """
    lead, batch = tuple(x_shape[:-2]), int(x_shape[-2])
    device = layers[0][0].device
    dims = [tuple(loc.shape) for loc, _, _ in layers]
    eps_flat = torch.randn(lead + (sum(i * o for i, o in dims),),
                           generator=generator, device=device)
    signs = rows_mod.draw(lambda s: _rademacher(s, generator, device),
                          lead + (batch, sum(i + o for i, o in dims)), axis=-2)
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


# ---------------------------------------------------------------------------
# BGM's variational decoders: input BatchNorm with running statistics, then
# mean and softplus-variance heads
# ---------------------------------------------------------------------------


def batchnorm_apply(gamma, beta, x, state, train: bool):
    """BatchNorm over axis 0; ``state`` is ``(running_mean, running_var)``.

    In ``train`` mode it normalises with the batch's mean and biased
    variance and returns the running statistics moved toward them
    (``momentum * old + (1 - momentum) * batch``, detached); in eval mode it
    normalises with ``state`` and returns it.  Returns ``(y, new_state)``."""
    if train:
        mean = torch.mean(x, dim=0)
        var = torch.mean((x - mean) ** 2, dim=0)
        new_state = tuple(BN_MOMENTUM * s + (1.0 - BN_MOMENTUM) * b.detach()
                          for s, b in zip(state, (mean, var)))
    else:
        (mean, var), new_state = state, state
    return (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta, new_state


class _VariationalBase(nn.Module):
    """The input norm's affine (``gamma``, ``beta``) and running statistics
    (buffers ``bn_mean``, ``bn_var``, initialised 0 and 1)."""

    def _init_norm(self, input_dim: int):
        self.gamma = nn.Parameter(torch.ones(input_dim))
        self.beta = nn.Parameter(torch.zeros(input_dim))
        self.register_buffer("bn_mean", torch.zeros(input_dim))
        self.register_buffer("bn_var", torch.ones(input_dim))

    def bn_state(self) -> tuple:
        return (self.bn_mean, self.bn_var)

    @torch.no_grad()
    def set_bn_state(self, state):
        """Copy ``(mean, var)`` into the running statistics, in place."""
        self.bn_mean.copy_(state[0])
        self.bn_var.copy_(state[1])


class VariationalMLP(_VariationalBase):
    """BGM's plain decoder ``dims = [in, *hidden, out]``: input BatchNorm,
    dense layers ``w[i]``, ``b[i]`` with LeakyReLU, then two dense heads,
    ``mean_w``/``mean_b`` and ``var_w``/``var_b`` (Glorot-uniform kernels,
    zero biases, drawn on the CPU from ``generator``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden)]
        self._init_norm(dims[0])
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w, b = _glorot_dense(d_in, d_out, generator)
            self.w.append(w)
            self.b.append(b)
        self.mean_w, self.mean_b = _glorot_dense(dims[-1], int(output_dim), generator)
        self.var_w, self.var_b = _glorot_dense(dims[-1], int(output_dim), generator)

    @property
    def dims(self) -> list:
        return [self.gamma.shape[0]] + [w.shape[1] for w in self.w] + [self.mean_w.shape[1]]


def variational_mlp_apply(net: VariationalMLP, x, train: bool = True, state=None,
                          eps: float = 1e-6):
    """``(mean, var, new_state)``: per-dimension mean and variance of x, and
    the input norm's running statistics after this call (see
    :func:`batchnorm_apply`; ``state`` defaults to the net's buffers, which
    are not written)."""
    x, new_state = batchnorm_apply(net.gamma, net.beta, x,
                                   net.bn_state() if state is None else state, train)
    for w, b in zip(net.w, net.b):
        x = leaky_relu(dense_apply(w, b, x))
    mean = dense_apply(net.mean_w, net.mean_b, x)
    var = softplus(dense_apply(net.var_w, net.var_b, x)) + eps
    return mean, var, new_state


class FlipoutVariationalMLP(_VariationalBase):
    """BGM's flipout decoder: input BatchNorm, flipout hidden layers
    ``loc[i]``, ``rho[i]``, ``b[i]`` with LeakyReLU, and flipout ``mean_*``
    and ``var_*`` heads (``loc ~ 0.1 N(0,1)``, ``rho ~ -3 + 0.1 N(0,1)``,
    ``b = 0``, drawn on the CPU from ``generator``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden)]
        self._init_norm(dims[0])
        self.loc = nn.ParameterList()
        self.rho = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            loc, rho, b = _flipout_init(d_in, d_out, generator)
            self.loc.append(loc)
            self.rho.append(rho)
            self.b.append(b)
        self.mean_loc, self.mean_rho, self.mean_b = _flipout_init(dims[-1], int(output_dim),
                                                                  generator)
        self.var_loc, self.var_rho, self.var_b = _flipout_init(dims[-1], int(output_dim),
                                                               generator)

    @property
    def dims(self) -> list:
        return ([self.gamma.shape[0]] + [loc.shape[1] for loc in self.loc]
                + [self.mean_loc.shape[1]])

    def layers(self) -> list:
        """``[(loc, rho, b), ...]``: the hidden layers, then the mean and
        variance heads (the order of the fused draw)."""
        return [*zip(self.loc, self.rho, self.b), (self.mean_loc, self.mean_rho, self.mean_b),
                (self.var_loc, self.var_rho, self.var_b)]


def flipout_variational_mlp_apply(net: FlipoutVariationalMLP, x, generator, train: bool = True,
                                  state=None, draws=None, eps: float = 1e-6):
    """:func:`variational_mlp_apply` through flipout layers: one fused draw
    over ``[*hidden, mean, var]`` from ``generator``, or ``draws`` (an
    earlier ``_fused_flipout_draws`` result for the same layers and rows)."""
    x, new_state = batchnorm_apply(net.gamma, net.beta, x,
                                   net.bn_state() if state is None else state, train)
    layers = net.layers()
    if draws is None:
        draws = _fused_flipout_draws(layers, x.shape, generator)
    e, r_in, r_out = draws
    for j, layer in enumerate(layers[:-2]):
        x = leaky_relu(_flipout_dense_pre(layer, x, e[j], r_in[j], r_out[j]))
    mean = _flipout_dense_pre(layers[-2], x, e[-2], r_in[-2], r_out[-2])
    var = softplus(_flipout_dense_pre(layers[-1], x, e[-1], r_in[-1], r_out[-1])) + eps
    return mean, var, new_state


def flipout_variational_mlp_kl(net: FlipoutVariationalMLP):
    """KL of every layer's kernel against N(0, 0.1^2), plus each bias's
    cross-entropy under the same prior."""
    return sum(flipout_dense_kl(layer, BVN_PRIOR_SCALE, BVN_PRIOR_SCALE)
               for layer in net.layers())


def reparameterize(mean, var, generator):
    """``mean + sqrt(var) * eps``, ``eps ~ N(0, I)`` from ``generator`` (the
    rows on axis 0)."""
    eps = rows_mod.draw(lambda s: torch.randn(s, generator=generator, device=mean.device,
                                              dtype=mean.dtype), mean.shape)
    return mean + torch.sqrt(var) * eps


# ---------------------------------------------------------------------------
# The low-rank variational nets: mean, diagonal variance and a low-rank
# factor U, Sigma = diag(var) + U U^T
# ---------------------------------------------------------------------------


class LowRankVariationalMLP(_VariationalBase):
    """``BaseVariationalLowRankNet``: the input norm (frozen), dense layers
    ``w[i]``, ``b[i]`` with LeakyReLU, then three dense heads: ``mean_*``
    and ``var_*`` of width ``output_dim`` and ``lowrank_*`` of width
    ``output_dim * rank`` (Glorot-uniform kernels, zero biases, drawn on the
    CPU from ``generator``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int], rank: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden)]
        self.rank = int(rank)
        self._init_norm(dims[0])
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w, b = _glorot_dense(d_in, d_out, generator)
            self.w.append(w)
            self.b.append(b)
        self.mean_w, self.mean_b = _glorot_dense(dims[-1], int(output_dim), generator)
        self.var_w, self.var_b = _glorot_dense(dims[-1], int(output_dim), generator)
        self.lowrank_w, self.lowrank_b = _glorot_dense(dims[-1], int(output_dim) * self.rank,
                                                       generator)

    @property
    def dims(self) -> list:
        return [self.gamma.shape[0]] + [w.shape[1] for w in self.w] + [self.mean_w.shape[1]]


def lowrank_variational_mlp_apply(net: LowRankVariationalMLP, x, state=None, train: bool = True,
                                  eps: float = 1e-6):
    """``(mean, var_diag, U, state)`` with ``U`` of shape ``(batch, out,
    rank)``.  The input norm runs frozen whatever ``train`` is, and
    ``state`` comes back as it was given (JAX's signature)."""
    x = frozen_batchnorm_apply(net.gamma, net.beta, x)
    for w, b in zip(net.w, net.b):
        x = leaky_relu(dense_apply(w, b, x))
    mean = dense_apply(net.mean_w, net.mean_b, x)
    var_diag = softplus(dense_apply(net.var_w, net.var_b, x)) + eps
    u = dense_apply(net.lowrank_w, net.lowrank_b, x).reshape(-1, mean.shape[-1], net.rank)
    return mean, var_diag, u, state


class FlipoutLowRankVariationalMLP(_VariationalBase):
    """``BayesianVariationalLowRankNet``: the input norm (frozen), flipout
    hidden layers ``loc[i]``, ``rho[i]``, ``b[i]`` with LeakyReLU, and
    flipout ``mean_*``, ``var_*`` and ``lowrank_*`` heads (``loc ~ 0.1
    N(0,1)``, ``rho ~ -3 + 0.1 N(0,1)``, ``b = 0``, drawn on the CPU from
    ``generator``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden: Sequence[int], rank: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [int(input_dim), *map(int, hidden)]
        self.rank = int(rank)
        self._init_norm(dims[0])
        self.loc = nn.ParameterList()
        self.rho = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            loc, rho, b = _flipout_init(d_in, d_out, generator)
            self.loc.append(loc)
            self.rho.append(rho)
            self.b.append(b)
        out = int(output_dim)
        self.mean_loc, self.mean_rho, self.mean_b = _flipout_init(dims[-1], out, generator)
        self.var_loc, self.var_rho, self.var_b = _flipout_init(dims[-1], out, generator)
        self.lowrank_loc, self.lowrank_rho, self.lowrank_b = _flipout_init(
            dims[-1], out * self.rank, generator)

    @property
    def dims(self) -> list:
        return ([self.gamma.shape[0]] + [loc.shape[1] for loc in self.loc]
                + [self.mean_loc.shape[1]])

    def layers(self) -> list:
        """``[(loc, rho, b), ...]``: the hidden layers, then the mean,
        variance and low-rank heads (the order of the fused draw)."""
        return [*zip(self.loc, self.rho, self.b),
                *((getattr(self, f"{h}_loc"), getattr(self, f"{h}_rho"), getattr(self, f"{h}_b"))
                  for h in ("mean", "var", "lowrank"))]


def flipout_lowrank_variational_mlp_apply(net: FlipoutLowRankVariationalMLP, x, generator,
                                          state=None, train: bool = True, draws=None,
                                          eps: float = 1e-6):
    """:func:`lowrank_variational_mlp_apply` through flipout layers: one
    fused draw over ``[*hidden, mean, var, lowrank]`` from ``generator``, or
    ``draws`` (an earlier ``_fused_flipout_draws`` result for the same
    layers and rows)."""
    x = frozen_batchnorm_apply(net.gamma, net.beta, x)
    layers = net.layers()
    if draws is None:
        draws = _fused_flipout_draws(layers, x.shape, generator)
    e, r_in, r_out = draws
    for j, layer in enumerate(layers[:-3]):
        x = leaky_relu(_flipout_dense_pre(layer, x, e[j], r_in[j], r_out[j]))
    mean = _flipout_dense_pre(layers[-3], x, e[-3], r_in[-3], r_out[-3])
    var_diag = softplus(_flipout_dense_pre(layers[-2], x, e[-2], r_in[-2], r_out[-2])) + eps
    u = _flipout_dense_pre(layers[-1], x, e[-1], r_in[-1], r_out[-1])
    return mean, var_diag, u.reshape(-1, mean.shape[-1], net.rank), state


def flipout_lowrank_variational_mlp_kl(net: FlipoutLowRankVariationalMLP):
    """KL of every layer's kernel against N(0, 0.1^2); the biases carry no
    prior (the reference's default bias)."""
    return sum(flipout_dense_kl(layer, BVN_PRIOR_SCALE) for layer in net.layers())


def lowrank_transfer_from_flipout(net: FlipoutLowRankVariationalMLP,
                                  generator: torch.Generator | None = None
                                  ) -> LowRankVariationalMLP:
    """The deterministic low-rank net of a flipout twin
    (``transfer_weights_from_bayesian``): each kernel is the posterior mean
    ``loc``, or with ``generator`` one draw ``loc + softplus(rho) eps`` per
    layer, in the order of :meth:`FlipoutLowRankVariationalMLP.layers`;
    biases and the input norm are copied."""
    out = LowRankVariationalMLP(net.dims[0], net.dims[-1], net.dims[1:-1], rank=net.rank)
    out.to(net.gamma.device)
    kernels = []
    with torch.no_grad():
        for loc, rho, _ in net.layers():
            if generator is None:
                kernels.append(loc)
            else:
                kernels.append(loc + softplus(rho) * torch.randn(
                    loc.shape, generator=generator, device=loc.device, dtype=loc.dtype))
        targets = [*zip(out.w, out.b), (out.mean_w, out.mean_b), (out.var_w, out.var_b),
                   (out.lowrank_w, out.lowrank_b)]
        for (w, b), kernel, (_, _, bias) in zip(targets, kernels, net.layers()):
            w.copy_(kernel)
            b.copy_(bias)
        out.gamma.copy_(net.gamma)
        out.beta.copy_(net.beta)
    return out


def lowrank_reparameterize(mean, var_diag, u, generator):
    """``mean + sqrt(var_diag) eps1 + U eps2``, ``eps1 ~ N(0, I_p)`` drawn
    first, then ``eps2 ~ N(0, I_rank)``, both from ``generator``."""
    eps1 = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    eps2 = torch.randn((mean.shape[0], u.shape[-1]), generator=generator, device=mean.device,
                       dtype=mean.dtype)
    return mean + torch.sqrt(var_diag) * eps1 + torch.einsum("bpr,br->bp", u, eps2)


def _capacitance(var_diag, u):
    """``(U^T D^-1, I + U^T D^-1 U)`` of ``Sigma = D + U U^T``."""
    ut_dinv = u.transpose(-1, -2) / var_diag[:, None, :]  # (b, r, p)
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return ut_dinv, eye + ut_dinv @ u


def lowrank_covariance_inverse(var_diag, u):
    """``Sigma^-1`` of ``Sigma = diag(var_diag) + U U^T`` by Woodbury:
    ``D^-1 - D^-1 U (I + U^T D^-1 U)^-1 U^T D^-1``, batched: ``(b, p, p)``."""
    ut_dinv, m = _capacitance(var_diag, u)
    correction = ut_dinv.transpose(-1, -2) @ torch.linalg.inv(m) @ ut_dinv
    return torch.diag_embed(1.0 / var_diag) - correction


def lowrank_log_det(var_diag, u):
    """``log det Sigma`` of ``Sigma = diag(var_diag) + U U^T`` by Sylvester:
    ``sum log var_diag + log det (I + U^T D^-1 U)``, batched: ``(b,)``."""
    _, m = _capacitance(var_diag, u)
    return torch.sum(torch.log(var_diag), dim=-1) + torch.linalg.slogdet(m)[1]


# ---------------------------------------------------------------------------
# Flat weights of a plain MLP (weight-space HMC)
# ---------------------------------------------------------------------------


class MLPWeights(NamedTuple):
    """A plain MLP's weights as tensors, for :func:`mlp_apply`: ``w[i]``
    ``(..., in, out)`` and ``b[i]`` ``(out,)``, or ``(K, 1, out)`` for a stack
    of K nets (then ``x`` is ``(K, rows, in)``)."""

    w: list
    b: list


def flatten_params(net: MLP):
    """``(flat, unravel)``: the MLP's weights as one float32 vector in the
    order of JAX's ``ravel_pytree`` over ``{"layers": [{"b", "w"}, ...]}``
    (``b0, w0, b1, w1, ...``, each ``w`` row-major ``(in, out)``), so a
    JAX flat sample means the same net here.  ``unravel(flat)`` returns
    :class:`MLPWeights` whose tensors are views of ``flat`` (differentiable
    in it); a ``(K, D)`` stack gives K nets' weights."""
    dims = net.dims
    flat = torch.cat([t.detach().reshape(-1) for b, w in zip(net.b, net.w) for t in (b, w)])
    width = flat.shape[0]

    def unravel(flat):
        if flat.shape[-1] != width:
            raise ValueError(f"a flat weight vector of {flat.shape[-1]} for an MLP of {width}")
        lead = flat.shape[:-1]
        ws, bs, at = [], [], 0
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            b = flat[..., at:at + d_out]
            bs.append(b.reshape(lead + (1, d_out)) if lead else b)
            at += d_out
            ws.append(flat[..., at:at + d_in * d_out].reshape(lead + (d_in, d_out)))
            at += d_in * d_out
        return MLPWeights(w=ws, b=bs)

    return flat, unravel


def standard_normal_log_prior(flat):
    """``sum log N(w; 0, 1)`` over the last axis."""
    return -0.5 * torch.sum(flat**2, dim=-1) - 0.5 * flat.shape[-1] * math.log(2 * math.pi)
