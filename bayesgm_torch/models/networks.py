"""Network facade: class-style wrappers over the port's nets (port of
``bayesgm_tpu/models/networks.py``).

The reference exposes network classes; the port's nets and their applies
live in :mod:`bayesgm_torch.ops.nn` and :mod:`bayesgm_torch.ops.conv`, and
the model engines use those directly.  Each class here is an
``nn.Module`` that holds one of them as ``net`` and owns a
``torch.Generator`` on its device for its stochastic forwards and draws
(the counterpart of the JAX facade's key chain).  The weights are drawn on
the CPU from ``seed``, so a seed gives the same net on every device.
BatchNorm running statistics move only on a forward with
``training=True``.  Inputs may be numpy arrays or tensors; outputs are
tensors on the module's device.  Every class takes ``device="cuda"`` and
raises without CUDA unless the CPU is asked for by name.

Mapping:

- ``BaseFullyConnectedNet``         -> ``ops.nn.MLP`` (+ frozen per-layer norms)
- ``BaseVariationalNet``            -> ``ops.nn.VariationalMLP``
- ``BaseVariationalLowRankNet``     -> ``ops.nn.LowRankVariationalMLP``
- ``Discriminator``                 -> ``ops.nn.Critic``
- ``BayesianFullyConnectedNet``     -> ``ops.nn.FlipoutMLP``
- ``BayesianVariationalNet``        -> ``ops.nn.FlipoutVariationalMLP``
- ``BayesianVariationalLowRankNet`` -> ``ops.nn.FlipoutLowRankVariationalMLP``
- ``MCMCFullyConnectedNet``         -> a plain MLP and its flat weights
                                       (``ops.nn.flatten_params``)
- ``run_mcmc_for_net``              -> weight-space HMC (``ops.mcmc.hmc``)
- ``MNISTEncoderConv/Generator/Discriminator`` -> ``ops.conv``
"""

from __future__ import annotations

import torch
from torch import nn

from bayesgm_torch.ops import conv as _conv
from bayesgm_torch.ops import mcmc as _mcmc
from bayesgm_torch.ops import nn as _nn
from bayesgm_torch.utils.device import resolve_device


class _SeededModule(nn.Module):
    """Base: the device, a CPU generator for the weights' init and a device
    generator for the stochastic forwards, both seeded with ``seed``."""

    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.init_generator = torch.Generator().manual_seed(int(seed))
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def _set_net(self, net: nn.Module):
        self.net = net.to(self.device)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _commit_bn_state(self, new_state, training: bool):
        if training:
            self.net.set_bn_state(new_state)


def _dense_chain(w, b, norms, act, x):
    """Dense layers with ``act`` between them, each hidden pre-activation
    through a frozen norm ``(gammas, betas)`` when given; a linear last
    layer."""
    for i in range(len(w) - 1):
        x = _nn.dense_apply(w[i], b[i], x)
        if norms is not None:
            x = _nn.frozen_batchnorm_apply(norms[0][i], norms[1][i], x)
        x = act(x)
    return _nn.dense_apply(w[-1], b[-1], x)


class BaseFullyConnectedNet(_SeededModule):
    """Plain LeakyReLU MLP with a linear last layer; with ``batchnorm`` a
    frozen norm (trainable ``bn_gamma[i]``/``bn_beta[i]``) after each hidden
    dense layer, as the reference invokes it."""

    def __init__(self, input_dim, output_dim, model_name="net", nb_units=(256, 256, 256),
                 batchnorm=False, seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.MLP(input_dim, output_dim, list(nb_units), self.init_generator))
        self.batchnorm = bool(batchnorm)
        if self.batchnorm:
            self.bn_gamma = nn.ParameterList(
                [nn.Parameter(torch.ones(h, device=self.device)) for h in nb_units])
            self.bn_beta = nn.ParameterList(
                [nn.Parameter(torch.zeros(h, device=self.device)) for h in nb_units])

    def forward(self, x, training=True):
        x = self._tensor(x)
        if not self.batchnorm:
            return _nn.mlp_apply(self.net, x)
        return _dense_chain(self.net.w, self.net.b, (self.bn_gamma, self.bn_beta),
                            _nn.leaky_relu, x)


class Discriminator(_SeededModule):
    """tanh critic with a scalar logit; with ``batchnorm`` (the default) a
    frozen norm after each hidden dense layer (``ops.nn.Critic``)."""

    def __init__(self, input_dim, model_name="critic", nb_units=(256, 256), batchnorm=True,
                 seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self.batchnorm = bool(batchnorm)
        cls = _nn.Critic if self.batchnorm else (lambda d, h, g: _nn.MLP(d, 1, h, g))
        self._set_net(cls(input_dim, list(nb_units), self.init_generator))

    def forward(self, x, training=True):
        x = self._tensor(x)
        if self.batchnorm:
            return _nn.critic_apply(self.net, x)
        return _dense_chain(self.net.w, self.net.b, None, torch.tanh, x)


class BaseVariationalNet(_SeededModule):
    """Mean and softplus-variance heads over an input BatchNorm with running
    statistics."""

    def __init__(self, input_dim, output_dim, model_name="vnet", nb_units=(256, 256, 256),
                 seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.VariationalMLP(input_dim, output_dim, list(nb_units),
                                         self.init_generator))

    def forward(self, x, training=True):
        mean, var, new_state = _nn.variational_mlp_apply(self.net, self._tensor(x),
                                                         train=training)
        self._commit_bn_state(new_state, training)
        return mean, var

    def reparameterize(self, mean, var):
        return _nn.reparameterize(mean, var, self.generator)


class _LowRankHeads:
    """The draws and the covariance algebra of ``Sigma = D + U U^T``."""

    def reparameterize(self, mean, var_diag, u):
        return _nn.lowrank_reparameterize(mean, var_diag, u, self.generator)

    def compute_covariance_inverse(self, var_diag, u):
        return _nn.lowrank_covariance_inverse(var_diag, u)

    def compute_log_det(self, var_diag, u):
        return _nn.lowrank_log_det(var_diag, u)


class BaseVariationalLowRankNet(_LowRankHeads, _SeededModule):
    """Mean, diagonal-variance and low-rank-factor heads with
    ``Sigma = diag(var) + U U^T``; the input norm runs frozen."""

    def __init__(self, input_dim, output_dim, model_name="lrnet", nb_units=(256, 256, 256),
                 rank=2, seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.LowRankVariationalMLP(input_dim, output_dim, list(nb_units), rank,
                                                self.init_generator))

    def forward(self, x, training=True):
        mean, var_diag, u, _ = _nn.lowrank_variational_mlp_apply(self.net, self._tensor(x))
        return mean, var_diag, u

    def transfer_weights_from_bayesian(self, bayesian_model, method="mean"):
        """Take the weights of a ``BayesianVariationalLowRankNet``: its
        posterior means, or (``"sample"``) one draw per layer from this
        module's generator."""
        if method not in ("mean", "sample"):
            raise ValueError(f"Invalid method '{method}'. Must be either 'mean' or 'sample'.")
        generator = None if method == "mean" else self.generator
        self._set_net(_nn.lowrank_transfer_from_flipout(bayesian_model.net, generator))


class BayesianFullyConnectedNet(_SeededModule):
    """Flipout MLP with N(0, 1) kernel priors."""

    def __init__(self, input_dim, output_dim, model_name="bnn", nb_units=(256, 256, 256),
                 seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.FlipoutMLP(input_dim, output_dim, list(nb_units),
                                     self.init_generator))

    def forward(self, x, training=True):
        return _nn.flipout_mlp_apply(self.net, self._tensor(x), self.generator)

    def kl_divergence(self):
        return _nn.flipout_mlp_kl(self.net)


class BayesianVariationalNet(_SeededModule):
    """Flipout variational MLP with N(0, 0.1) kernel and bias priors."""

    def __init__(self, input_dim, output_dim, model_name="bvn", nb_units=(256, 256, 256),
                 seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.FlipoutVariationalMLP(input_dim, output_dim, list(nb_units),
                                                self.init_generator))

    def forward(self, x, training=True):
        mean, var, new_state = _nn.flipout_variational_mlp_apply(
            self.net, self._tensor(x), self.generator, train=training)
        self._commit_bn_state(new_state, training)
        return mean, var

    def reparameterize(self, mean, var):
        return _nn.reparameterize(mean, var, self.generator)

    def kl_divergence(self):
        return _nn.flipout_variational_mlp_kl(self.net)


class BayesianVariationalLowRankNet(_LowRankHeads, _SeededModule):
    """Flipout low-rank variational MLP with N(0, 0.1) kernel priors."""

    def __init__(self, input_dim, output_dim, model_name="blr", nb_units=(256, 256, 256),
                 rank=2, seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = model_name
        self._set_net(_nn.FlipoutLowRankVariationalMLP(input_dim, output_dim, list(nb_units),
                                                        rank, self.init_generator))

    def forward(self, x, training=True):
        mean, var_diag, u, _ = _nn.flipout_lowrank_variational_mlp_apply(
            self.net, self._tensor(x), self.generator)
        return mean, var_diag, u

    def kl_divergence(self):
        return _nn.flipout_lowrank_variational_mlp_kl(self.net)


class MCMCFullyConnectedNet(BaseFullyConnectedNet):
    """Plain MLP with a flat-weight forward and a standard-normal log prior
    over its flat weights (JAX's ``ravel_pytree`` order,
    ``ops.nn.flatten_params``).  Its flat path covers the plain MLP only:
    ``batchnorm=True`` raises."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.batchnorm:
            raise ValueError("MCMCFullyConnectedNet's flat weights cover a plain MLP: "
                             "batchnorm=True is not supported")
        self._flat0, self._unravel = _nn.flatten_params(self.net)

    def get_weights(self):
        return self._flat0

    def call_with_weights(self, inputs, flattened_weights):
        """The MLP at ``flattened_weights`` (``(D,)``, or ``(K, D)`` for K
        nets, then ``inputs`` is ``(K, rows, in)`` or broadcasts to it)."""
        return _nn.mlp_apply(self._unravel(self._tensor(flattened_weights)),
                             self._tensor(inputs))

    def log_prior(self, flattened_weights):
        return _nn.standard_normal_log_prior(self._tensor(flattened_weights))


def run_mcmc_for_net(net: MCMCFullyConnectedNet, x_train, y_train, likelihood_fn,
                     initial_state=None, num_samples=1000, num_burnin_steps=500,
                     step_size=0.01, num_leapfrog_steps=3, seed=0):
    """Weight-space HMC for ``net`` (one chain, step size adapted over the
    first 80 % of the burn-in).  ``likelihood_fn(y_true, y_pred)`` returns a
    differentiable scalar log-likelihood.  Returns the weight samples as a
    numpy array of shape ``(num_samples, n_weights)``."""
    x_train, y_train = net._tensor(x_train), net._tensor(y_train)
    flat0 = net.get_weights() if initial_state is None else net._tensor(initial_state)

    def log_prob(flat_batch, generator):
        y_pred = net.call_with_weights(x_train, flat_batch)  # (chains, rows, out)
        lik = torch.stack([likelihood_fn(y_train, y_pred[k]) for k in range(len(flat_batch))])
        return net.log_prior(flat_batch) + lik

    print(f"Running HMC for {net.model_name}...")
    res = _mcmc.hmc(log_prob, flat0[None, :], torch.Generator(device=net.device).manual_seed(seed),
                    burn_in=num_burnin_steps, n_keep=num_samples, step_size=step_size,
                    num_leapfrog=num_leapfrog_steps, adapt_fraction=0.8)
    print(f"HMC for {net.model_name} finished. Acceptance rate: {float(res.accept_rate):.4f}")
    return res.samples[:, 0, :].cpu().numpy()


def _nhwc(images):
    """``(n, 1, 28, 28)`` -> JAX's ``(n, 28, 28, 1)`` (one channel: a
    reshape)."""
    return images.reshape(images.shape[0], 28, 28, 1)


class MNISTEncoderConv(_SeededModule):
    """Convolutional encoder: images ``(n, 28, 28, 1)`` -> ``(n, z_dim)``."""

    def __init__(self, z_dim=10, filters=32, name="mnist_encoder_conv", seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = name
        self._set_net(_conv.MNISTEncoder(z_dim, filters, self.init_generator))

    @_conv.f32_convolutions
    def forward(self, x, training=True):
        return _conv.mnist_encoder_apply(self.net, self._tensor(x))


class MNISTGenerator(_SeededModule):
    """Deconvolutional generator: ``(n, z_dim)`` -> ``(mean_logits, var)``,
    each ``(n, 28, 28, 1)``; ``use_bnn`` for the flipout generator."""

    def __init__(self, z_dim=10, filters=32, use_bnn=False, kl_weight=1.0 / 60000,
                 name="mnist_generator", seed=0, device="cuda"):
        super().__init__(seed, device)
        self.model_name = name
        self.kl_weight = kl_weight
        self._set_net(_conv.MNISTGenerator(z_dim, filters, use_bnn, self.init_generator))

    @_conv.f32_convolutions
    def forward(self, z, training=True):
        mean, var = _conv.mnist_generator_apply(
            self.net, self._tensor(z), self.generator if self.net.bayesian else None)
        return _nhwc(mean), _nhwc(var)

    def reparameterize(self, mean, var):
        return _nn.reparameterize(mean, var, self.generator)

    def kl_divergence(self):
        return _conv.mnist_generator_kl(self.net) * self.kl_weight


class MNISTDiscriminator(_SeededModule):
    """Convolutional critic for MNIST-sized images, dropout while
    ``training``."""

    def __init__(self, filters=64, dropout=0.3, name="mnist_discriminator", seed=0,
                 device="cuda"):
        super().__init__(seed, device)
        self.model_name = name
        self.dropout = dropout
        self._set_net(_conv.MNISTDiscriminator(filters, self.init_generator))

    @_conv.f32_convolutions
    def forward(self, x, training=True):
        return _conv.mnist_discriminator_apply(self.net, self._tensor(x),
                                               self.generator if training else None,
                                               dropout=self.dropout)


__all__ = [
    "BaseFullyConnectedNet",
    "BayesianFullyConnectedNet",
    "BaseVariationalNet",
    "BayesianVariationalNet",
    "BaseVariationalLowRankNet",
    "BayesianVariationalLowRankNet",
    "Discriminator",
    "MCMCFullyConnectedNet",
    "run_mcmc_for_net",
    "MNISTEncoderConv",
    "MNISTGenerator",
    "MNISTDiscriminator",
]
