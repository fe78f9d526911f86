"""MNISTBGM: BGM for 28 x 28 x 1 images with a Bernoulli pixel likelihood
(port of ``bayesgm_tpu/models/mnist.py``).

The conv encoder, generator and image critic of ``ops/conv.py`` take the
place of BGM's MLPs; everything else is BGM's (``models/bgm.py``): the
dual-LSGAN warm start, the iterative fit over the latent table, HMC over
``p(Z | X_obs)`` with NaN-encoded missing pixels, the full-state checkpoint
and exact resume.  What differs:

- the generator's logits are reparameterised (``mean + sqrt(var) * eps``)
  wherever it is applied, and clipped to +-10 wherever the Bernoulli
  likelihood reads them; ``evaluate``, ``generate`` and ``predict``'s decode
  take their sigmoid unclipped;
- channel BatchNorm normalises with the batch's statistics in every call:
  the nets keep no running statistics (no ``g_state``), and the rows of one
  HMC subject batch share them, so its chains are not independent;
- the HMC target is stochastic for both generators (the reparameterisation
  noise, and the flipout generator's weight noise): ``hmc`` runs in its
  ``noise`` mode, where one draw serves every gradient of a step's
  leapfrog and another its end point's value (``num_leapfrog + 2``
  evaluations per step);
- the critic's dropout is on in the EGM's critic and generator steps.

No kernel runs here: the JAX counterpart launches no Pallas kernel, and its
convolutions are XLA's; the port's are ``torch.nn.functional``'s, in f32:
every entry point of the class turns cuDNN's TF32 off while it runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesgm_torch.models.bgm import BGM, _gradient_penalty, _interp_weights, _params
from bayesgm_torch.ops import conv
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import optim
from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops.distributions import softplus
from bayesgm_torch.ops.nn import Critic, critic_apply

GEN_FILTERS, ENC_FILTERS, DISC_FILTERS = 32, 32, 64  # the widths JAX's MNISTBGM fixes
GEN_SAMPLES = 512  # images of each generate() the save_res files hold
LOGIT_CLIP = 10.0


class MNISTConfig(NamedTuple):
    z_dim: int
    use_bnn: bool
    kl_weight: float
    lr: float
    lr_theta: float
    lr_z: float
    gamma: float
    alpha: float
    g_d_freq: int


class GenDraws(NamedTuple):
    """The randomness of one generator pass over ``n`` rows."""

    flipout: Optional[list]  # conv.flipout_draws of the flipout layers; None for plain
    rep: torch.Tensor  # (n, 1, 28, 28) N(0, 1): the logits' reparameterisation noise


def _gen_draws(cfg: MNISTConfig, g, n: int, generator) -> GenDraws:
    flip = conv.flipout_draws(g.flipout_layers(), n, generator) if cfg.use_bnn else None
    rep = rows_mod.draw(lambda s: torch.randn(s, generator=generator, device=g.fc.w.device),
                        (n,) + conv.IMAGE_SHAPE)
    return GenDraws(flip, rep)


def _gen_logits(cfg: MNISTConfig, g, z, draws: GenDraws):
    """``(logits, var)``: the reparameterised logits ``mean + sqrt(var) *
    eps`` of ``g(z)`` under ``draws``, and the variance head."""
    mu, var = conv.mnist_generator_apply(g, z, draws=draws.flipout)
    return mu + torch.sqrt(var) * draws.rep, var


def _bernoulli_terms(x, logits):
    """``x * l - softplus(l)`` per pixel, the logits clipped to +-10."""
    logits = torch.clamp(logits, -LOGIT_CLIP, LOGIT_CLIP)
    return x * logits - softplus(logits)


def _bernoulli_ll(x, logits):
    """Per-image Bernoulli log likelihood, shape ``(n,)``."""
    return torch.sum(_bernoulli_terms(x, logits), dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# iterative-phase step
# ---------------------------------------------------------------------------


def _g_loss(cfg: MNISTConfig, g, z, x, draws: GenDraws):
    """``(loss, mse)``: the batch's mean Bernoulli NLL (plus ``kl_weight`` x
    the flipout layers' KL) and the mean squared pixel error of the
    probabilities."""
    logits, _ = _gen_logits(cfg, g, z, draws)
    loss_mse = torch.mean((x - torch.sigmoid(logits)) ** 2)
    loss = -torch.mean(_bernoulli_ll(x, logits))
    if cfg.use_bnn:
        loss = loss + conv.mnist_generator_kl(g) * cfg.kl_weight
    return loss, loss_mse


def _latent_loss(cfg: MNISTConfig, g, z, x, draws: GenDraws):
    """Batch mean of ``-log p(x|z) - log p(z)``."""
    logits, _ = _gen_logits(cfg, g, z, draws)
    return (-torch.mean(_bernoulli_ll(x, logits))
            + torch.mean(dist.standard_normal_neg_log_prior(z)))


def _train_batch_step(cfg: MNISTConfig, g, opt_g, z_table, z_opt, idx, generator, data_x,
                      lr_scale=1.0):
    """One iterative-updating step, in place (as BGM's): an Adam step of g
    at ``lr_theta * lr_scale`` on its batch loss, then, through the updated
    g under a new draw, a row-sparse Adam step of the batch's latent rows at
    ``lr_z * lr_scale``.  Returns ``(opt_g, z_opt, losses)``; ``idx`` may be
    a mesh minibatch (:func:`~bayesgm_torch.ops.optim.rows_at`)."""
    bx, bz = optim.rows_at(idx, data_x, z_table)
    n = bz.shape[0]
    loss_x, loss_mse = _g_loss(cfg, g, bz, bx, _gen_draws(cfg, g, n, generator))
    params = list(g.parameters())
    opt_g = optim.adam_update(torch.autograd.grad(loss_x, params), opt_g, params,
                              cfg.lr_theta * lr_scale)
    zr = bz.detach().requires_grad_(True)
    loss_post = _latent_loss(cfg, g, zr, bx, _gen_draws(cfg, g, n, generator))
    (z_grads,) = torch.autograd.grad(loss_post, zr)
    z_opt = optim.table_adam_update_batch(z_grads, idx, z_opt, z_table, cfg.lr_z * lr_scale)
    losses = dict(loss_x=loss_x, loss_mse_x=loss_mse, loss_postrior_z=loss_post)
    return opt_g, z_opt, {k: t.detach() for k, t in losses.items()}


# ---------------------------------------------------------------------------
# EGM initialization (dual LSGAN)
# ---------------------------------------------------------------------------


def _image_gradient_penalty(critic, points, generator):
    """``mean((||d critic / d points|| - 1)^2)`` over each image's pixels,
    the critic's dropout on; differentiable in its parameters (a double
    backward)."""
    points = points.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        torch.sum(conv.mnist_discriminator_apply(critic, points, generator)), points,
        create_graph=True)
    return torch.mean((torch.sqrt(torch.sum(grad**2, dim=(1, 2, 3))) - 1.0) ** 2)


def _egm_disc_step(cfg: MNISTConfig, nets, opt_d, z, x, generator):
    """LSGAN step of both critics, in place: targets 0.9 (real) and 0.1
    (fake) in latent space (``e(x)`` fake) and image space (the sigmoid of
    a reparameterised ``g(z)``), the image critic's dropout on, plus
    ``gamma`` x the gradient penalties at one interpolate each (skipped at
    ``gamma == 0``, where JAX multiplies them by 0); one Adam state (b1
    0.5, b2 0.9) over both.  Returns ``(opt_d, losses)``."""
    eps_z, eps_x = _interp_weights(generator, z.device)
    with torch.no_grad():
        z_fake = conv.mnist_encoder_apply(nets["e"], x)
        logits, _ = _gen_logits(cfg, nets["g"], z, _gen_draws(cfg, nets["g"], z.shape[0],
                                                                 generator))
        x_fake = torch.sigmoid(logits)
    dz, dx = nets["dz"], nets["dx"]
    d_x_fake = conv.mnist_discriminator_apply(dx, x_fake, generator)
    d_x_real = conv.mnist_discriminator_apply(dx, x, generator)
    dz_loss = (torch.mean((0.9 - critic_apply(dz, z)) ** 2)
               + torch.mean((0.1 - critic_apply(dz, z_fake)) ** 2)) / 2.0
    dx_loss = (torch.mean((0.9 - d_x_real) ** 2) + torch.mean((0.1 - d_x_fake) ** 2)) / 2.0
    d_loss = dx_loss + dz_loss
    if cfg.gamma:
        gpz = _gradient_penalty(dz, z * eps_z + z_fake * (1.0 - eps_z))
        gpx = _image_gradient_penalty(dx, x * eps_x + x_fake * (1.0 - eps_x), generator)
        d_loss = d_loss + cfg.gamma * (gpz + gpx)
    params = _params(nets, ("dz", "dx"))
    opt_d = optim.adam_update(torch.autograd.grad(d_loss, params), opt_d, params, cfg.lr,
                              b1=0.5, b2=0.9)
    losses = dict(dz_loss=dz_loss, dx_loss=dx_loss, d_loss=d_loss)
    return opt_d, {k: t.detach() for k, t in losses.items()}


def _egm_gen_step(cfg: MNISTConfig, nets, opt_ge, z, x, generator):
    """Joint g/e step, in place: LSGAN terms toward 0.9 for ``x_fake =
    sigmoid(g(z))`` (the image critic's dropout on) and ``z_fake = e(x)``,
    ``10 x`` the round trips ``e(x_fake)`` and ``sigmoid(g(z_fake))`` (each
    g pass reparameterised under its own draw), and ``alpha`` x the mean
    squared variance.  One Adam state (b1 0.5, b2 0.9) over g and e.
    Returns ``(opt_ge, losses)``."""
    g, e = nets["g"], nets["e"]
    n = z.shape[0]
    logits, var = _gen_logits(cfg, g, z, _gen_draws(cfg, g, n, generator))
    x_fake = torch.sigmoid(logits)
    reg_loss = torch.mean(var**2)
    z_fake = conv.mnist_encoder_apply(e, x)
    z_rec = conv.mnist_encoder_apply(e, x_fake)
    logits2, _ = _gen_logits(cfg, g, z_fake, _gen_draws(cfg, g, n, generator))
    x_rec = torch.sigmoid(logits2)

    d_x_fake = conv.mnist_discriminator_apply(nets["dx"], x_fake, generator)
    d_z_fake = critic_apply(nets["dz"], z_fake)
    l2_loss_x = torch.mean((x - x_rec) ** 2)
    l2_loss_z = torch.mean((z - z_rec) ** 2)
    g_loss_adv = torch.mean((0.9 - d_x_fake) ** 2)
    e_loss_adv = torch.mean((0.9 - d_z_fake) ** 2)
    g_e_loss = g_loss_adv + e_loss_adv + 10.0 * (l2_loss_x + l2_loss_z) + cfg.alpha * reg_loss
    params = _params(nets, ("g", "e"))
    opt_ge = optim.adam_update(torch.autograd.grad(g_e_loss, params), opt_ge, params, cfg.lr,
                               b1=0.5, b2=0.9)
    losses = dict(g_loss_adv=g_loss_adv, e_loss_adv=e_loss_adv, l2_loss_z=l2_loss_z,
                  l2_loss_x=l2_loss_x, reg_loss=reg_loss, g_e_loss=g_e_loss)
    return opt_ge, {k: t.detach() for k, t in losses.items()}


# ---------------------------------------------------------------------------
# imputation target
# ---------------------------------------------------------------------------


def _masked_log_prob(cfg: MNISTConfig, g, z, data, mask, draws: GenDraws):
    """``log p(z | x_obs)`` up to a constant per row: the flat ``(n, 784)``
    pixels' Bernoulli terms times the dense observed ``mask`` (None: every
    pixel observed)."""
    logits, _ = _gen_logits(cfg, g, z, draws)
    term = _bernoulli_terms(data, logits.reshape(z.shape[0], -1))
    if mask is not None:
        term = term * mask
    return -dist.standard_normal_neg_log_prior(z) + torch.sum(term, dim=1)


class MNISTBGM(BGM):
    """BGM for MNIST-shaped images ``(n, 28, 28, 1)`` with pixels in [0, 1],
    on one device.

    Parameters are :class:`~bayesgm_torch.models.bgm.BGM`'s (``x_dim``
    defaults to 784; ``g_units``, ``e_units`` and ``dx_units`` are unused:
    the generator and encoder have 32 filters, the image critic 64, as in
    the JAX package).  ``use_bnn`` picks the flipout generator.

    ``fit`` takes images (``(n, 28, 28, 1)``, ``(n, 1, 28, 28)`` or flat
    ``(n, 784)``); ``predict`` takes NaN-holed images ``(n, 28, 28, 1)`` and
    returns the imputed images and the intervals of the missing pixels (flat
    pixel order), ``return_samples`` the ``(n_mcmc, n, 28, 28, 1)`` cube of
    decoded draws and ``return_diagnostics`` image-shaped ESS and split-R-hat.
    The chains of one subject batch (``bs``) share channel BatchNorm's
    statistics, as in the JAX package.  ``generate`` returns images only.
    """

    _train_batch_step = staticmethod(_train_batch_step)
    _egm_disc_step = staticmethod(_egm_disc_step)
    _egm_gen_step = staticmethod(_egm_gen_step)

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        super().__init__({"x_dim": 784, **params}, timestamp, random_seed, device)

    @staticmethod
    def _make_config(p):
        return MNISTConfig(
            z_dim=int(p["z_dim"]), use_bnn=bool(p["use_bnn"]), kl_weight=float(p["kl_weight"]),
            lr=float(p["lr"]), lr_theta=float(p["lr_theta"]), lr_z=float(p["lr_z"]),
            gamma=float(p["gamma"]), alpha=float(p["alpha"]), g_d_freq=int(p["g_d_freq"]))

    def _make_nets(self, init_gen) -> dict:
        z = self.cfg.z_dim
        return {
            "g": conv.MNISTGenerator(z, GEN_FILTERS, self.cfg.use_bnn, init_gen),
            "e": conv.MNISTEncoder(z, ENC_FILTERS, init_gen),
            "dz": Critic(z, self.params["dz_units"], init_gen),
            "dx": conv.MNISTDiscriminator(DISC_FILTERS, init_gen),
        }

    def _train_data(self, data):
        """Images as ``(n, 1, 28, 28)`` float32 on the device."""
        return self._data(data).reshape((-1,) + conv.IMAGE_SHAPE)

    @torch.no_grad()
    def _encode(self, data):
        return conv.mnist_encoder_apply(self.nets["e"], data)

    def _g_state(self):
        return None

    def _save_egm_generated(self, path, data, write=True):
        gen = self.generate(nb_samples=GEN_SAMPLES)
        if write:
            np.savez(path, data_gen=gen)

    def _save_generated(self, path, z, write=True):
        gen = self.generate(nb_samples=GEN_SAMPLES)
        if write:
            np.savez(path, gen=gen, z=z)

    def _decode(self, g, z, generator):
        """Pixel probabilities of a reparameterised ``g(z)``, ``(n, 28, 28,
        1)``."""
        logits, _ = _gen_logits(self.cfg, g, z, _gen_draws(self.cfg, g, z.shape[0], generator))
        return torch.sigmoid(logits).reshape(-1, 28, 28, 1)

    # -- evaluation / generation ---------------------------------------------

    @conv.f32_convolutions
    @torch.no_grad()
    def evaluate(self, data, data_z=None, generator=None):
        """Pixel MSE (a 0-d device tensor) of the decoded probabilities of
        ``data_z`` (default ``e(data)``); ``generator`` defaults to a fresh
        fork of the model's stream."""
        data = self._train_data(data)
        gen = self._fork_generator() if generator is None else generator
        z = self._encode(data) if data_z is None else self._data(data_z)
        return rows_mod.mean((data.reshape(-1, 28, 28, 1) - self._decode(self.nets["g"], z, gen))
                             ** 2)

    @conv.f32_convolutions
    @torch.no_grad()
    def generate(self, nb_samples=1000):
        """Images ``(nb_samples, 28, 28, 1)`` (numpy) with pixels in [0, 1]."""
        z = torch.randn((nb_samples, self.cfg.z_dim), generator=self._gen, device=self.device)
        return self._decode(self.nets["g"], z, self._gen).cpu().numpy()

    @conv.f32_convolutions
    @torch.no_grad()
    def predict_on_posteriors(self, data_posterior_z):
        """Decoded images of posterior Z draws: ``(n_mcmc, n, z_dim)`` in,
        ``(n_mcmc, n, 28, 28, 1)`` numpy out (one generator pass)."""
        z = self._data(data_posterior_z)
        n_mcmc, n = z.shape[0], z.shape[1]
        x = self._decode(self.nets["g"], z.reshape(-1, self.cfg.z_dim), self._gen)
        return x.reshape(n_mcmc, n, 28, 28, 1).cpu().numpy()

    # -- posterior inference -----------------------------------------------------

    @conv.f32_convolutions
    def get_log_posterior(self, data_z, data_x, ind_x1=None, obs_mask=None, generator=None):
        """``log p(z | x_obs)`` up to a constant, shape ``(n,)``, over the
        flat pixels; with ``ind_x1`` (an ``(n, K)`` index array) only the
        gathered pixels count, each weighed by ``obs_mask`` where given."""
        z = self._data(data_z)
        n = z.shape[0]
        x = self._data(data_x).reshape(n, -1)
        gen = self._gen if generator is None else generator
        g = self.nets["g"]
        logits, _ = _gen_logits(self.cfg, g, z, _gen_draws(self.cfg, g, n, gen))
        logits = logits.reshape(n, -1)
        if ind_x1 is not None:
            ind = torch.as_tensor(np.asarray(ind_x1), dtype=torch.long, device=self.device)
            x, logits = torch.gather(x, 1, ind), torch.gather(logits, 1, ind)
        term = _bernoulli_terms(x, logits)
        if ind_x1 is not None and obs_mask is not None:
            term = term * self._data(obs_mask)
        return -dist.standard_normal_neg_log_prior(z) + torch.sum(term, dim=1)

    # BGM's entry points, their convolutions f32 (see conv.f32_convolutions)
    egm_init = conv.f32_convolutions(BGM.egm_init)
    fit = conv.f32_convolutions(BGM.fit)
    tfp_mcmc_sampler = conv.f32_convolutions(BGM.tfp_mcmc_sampler)
    predict = conv.f32_convolutions(BGM.predict)

    def _hmc_target(self, n: int):
        """The Bernoulli target, stochastic for both generators: ``noise``
        draws one :class:`GenDraws` over the ``n`` chains."""
        cfg, g = self.cfg, self.nets["g"]

        def noise(generator):
            return _gen_draws(cfg, g, n, generator)

        def log_prob(p, z, draws):
            return _masked_log_prob(cfg, p["nets"]["g"], z, p["data"], p["mask"], draws)
        return log_prob, noise

    def _decode_p(self, params, z, generator):
        return self._decode(params["nets"]["g"], z, generator)
