"""BGM: the Bayesian generative model for tabular data (port of
``bayesgm_tpu/models/bgm.py``).

``Z ~ N(0, I)``, ``X | Z ~ N(mu(Z), diag(sigma^2(Z)))`` through a decoder g
with an input BatchNorm that keeps running statistics: a plain variational
MLP (``use_bnn=False``, the default) or a flipout one (``use_bnn=True``).
On one device:

- ``fit``: the dual-LSGAN EGM warm start (:meth:`BGM.egm_init`: critics in
  latent and data space, encoder e and decoder g), the ``e(X)`` latent init,
  then iterative updating: per batch, an Adam step of g on its Gaussian NLL
  (train-mode BatchNorm, running statistics updated), then a row-sparse Adam
  step on the latent table through the updated g;
- ``predict``: HMC over ``p(Z | X_obs)`` per subject with NaN-encoded
  missing entries (a dense observed mask in the target), each kept step
  decoded to one reparameterised ``x`` draw; imputed means, per-missing-entry
  intervals and, on request, ESS and split-R-hat of the draws.  The flipout
  decoder's target is stochastic: :func:`bayesgm_torch.ops.mcmc.hmc` runs it
  in its ``noise`` mode (one draw per step for the leapfrog's gradients,
  another for the end point's value, as the JAX package keys them).

No kernel runs here: BGM's JAX counterpart launches no Pallas kernel.  With
``params['save_model']`` ``fit`` checkpoints its full state in the JAX
package's format (the generators' states in place of its key) and a new
instance resumes it exactly; ``params['metrics_path']`` logs one JSONL
record per evaluation.  The model runs on ``device="cuda"`` by default and
raises where CUDA is absent; ``device="cpu"`` (by name) runs on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch

from bayesgm_torch import bridge
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import mcmc, optim
from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops import nn as nn_ops  # _fused_flipout_draws, looked up per call
from bayesgm_torch.ops.nn import (
    MLP,
    Critic,
    FlipoutVariationalMLP,
    VariationalMLP,
    critic_apply,
    flipout_variational_mlp_apply,
    flipout_variational_mlp_kl,
    mlp_apply,
    reparameterize,
    variational_mlp_apply,
)
from bayesgm_torch.parallel.mesh import mesh_batches, takes_mesh, writes_files
from bayesgm_torch.utils import checkpoint as ckpt
from bayesgm_torch.utils.device import resolve_device
from bayesgm_torch.utils.profiling import MetricsLogger


class BGMConfig(NamedTuple):
    x_dim: int
    z_dim: int
    use_bnn: bool
    kl_weight: float
    lr: float
    lr_theta: float
    lr_z: float
    gamma: float
    alpha: float
    g_d_freq: int


DEFAULTS = dict(
    use_bnn=False,
    g_units=[64, 64, 64, 64, 64],
    e_units=[64, 64, 64, 64, 64],
    dz_units=[64, 32, 8],
    dx_units=[64, 32, 8],
    lr=0.001,
    lr_theta=0.005,
    lr_z=0.005,
    gamma=0.0,
    alpha=0.0,
    g_d_freq=1,
    save_model=False,
    save_res=True,
    kl_weight=0.00005,
)

NET_NAMES = ("g", "e", "dz", "dx")
GEN_SAMPLES = 5000  # rows of each generate() the eval slots write with save_res


def _g_apply(cfg: BGMConfig, g, z, generator, train: bool, state=None, draws=None):
    """Decoder forward: ``(mean, var, new_bn_state)`` (see
    :func:`~bayesgm_torch.ops.nn.variational_mlp_apply`)."""
    if cfg.use_bnn:
        return flipout_variational_mlp_apply(g, z, generator, train=train, state=state,
                                             draws=draws)
    return variational_mlp_apply(g, z, train=train, state=state)


def _g_kl(cfg: BGMConfig, g):
    return flipout_variational_mlp_kl(g) if cfg.use_bnn else 0.0


def _params(nets, names):
    return [p for k in names for p in nets[k].parameters()]


# ---------------------------------------------------------------------------
# Iterative-phase step
# ---------------------------------------------------------------------------


def _g_loss(cfg: BGMConfig, g, z, x, generator):
    """The decoder's Gaussian NLL (batch mean, plus ``kl_weight`` x KL for
    the flipout decoder) in train mode: ``(loss, mse, new_bn_state)``."""
    mu, sigma_sq, new_state = _g_apply(cfg, g, z, generator, train=True)
    loss_mse = torch.mean((x - mu) ** 2)
    loss = torch.mean(dist.gaussian_nll_diag(x, mu, sigma_sq))
    return loss + _g_kl(cfg, g) * cfg.kl_weight, loss_mse, new_state


def _latent_loss(cfg: BGMConfig, g, z, x, generator):
    """Batch mean of ``-log p(x|z) - log p(z)``; g in train mode (batch
    statistics, the new running statistics discarded)."""
    mu, sigma_sq, _ = _g_apply(cfg, g, z, generator, train=True)
    loss_px = torch.mean(dist.gaussian_nll_diag(x, mu, sigma_sq))
    return loss_px + torch.mean(dist.standard_normal_neg_log_prior(z))


def _train_batch_step(cfg: BGMConfig, g, opt_g, z_table, z_opt, idx, generator, data_x,
                      lr_scale=1.0):
    """One iterative-updating step, in place: an Adam step of g at
    ``lr_theta * lr_scale`` on its batch NLL (the running statistics take
    this pass's update), then, through the updated g, a row-sparse Adam step
    of the batch's latent rows at ``lr_z * lr_scale``.  Returns ``(opt_g,
    z_opt, losses)``; the losses are 0-d tensors on the device.  ``idx``
    may be a mesh minibatch (:func:`~bayesgm_torch.ops.optim.rows_at`)."""
    bx, bz = optim.rows_at(idx, data_x, z_table)
    loss_x, loss_mse, new_state = _g_loss(cfg, g, bz, bx, generator)
    params = list(g.parameters())
    opt_g = optim.adam_update(torch.autograd.grad(loss_x, params), opt_g, params,
                              cfg.lr_theta * lr_scale)
    g.set_bn_state(new_state)
    zr = bz.detach().requires_grad_(True)
    loss_post = _latent_loss(cfg, g, zr, bx, generator)
    (z_grads,) = torch.autograd.grad(loss_post, zr)
    z_opt = optim.table_adam_update_batch(z_grads, idx, z_opt, z_table, cfg.lr_z * lr_scale)
    losses = dict(loss_x=loss_x, loss_mse_x=loss_mse, loss_postrior_z=loss_post)
    return opt_g, z_opt, {k: t.detach() for k, t in losses.items()}


# ---------------------------------------------------------------------------
# EGM initialization (dual LSGAN)
# ---------------------------------------------------------------------------


def _interp_weights(generator, device):
    """The gradient penalty's two interpolation weights, latent and data
    space: U(0, 1) scalars, one pair per critic step."""
    w = torch.rand((2,), generator=generator, device=device)
    return w[0], w[1]


def _egm_batch(generator, n: int, batch_size: int, z_dim: int, device):
    """One EGM step's batch: row indices (with replacement) and N(0, I) z."""
    idx = torch.randint(0, n, (batch_size,), generator=generator, device=device)
    return idx, torch.randn((batch_size, z_dim), generator=generator, device=device)


def _gradient_penalty(critic, points):
    """``mean((||d critic / d points|| - 1)^2)``, differentiable in the
    critic's parameters (a double backward)."""
    points = points.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(torch.sum(critic_apply(critic, points)), points,
                                  create_graph=True)
    return torch.mean((torch.sqrt(torch.sum(grad**2, dim=1)) - 1.0) ** 2)


def _egm_disc_step(cfg: BGMConfig, nets, opt_d, z, x, generator):
    """LSGAN step of both critics, in place: targets 0.9 (real) and 0.1
    (fake) in latent space (``e(x)`` fake) and data space (a reparameterised
    ``g(z)`` fake, g in train mode with its new running statistics
    discarded), plus ``gamma`` x the gradient penalties at one interpolate
    each; one Adam state (b1 0.5, b2 0.9) over both.  Returns ``(opt_d,
    losses)``."""
    eps_z, eps_x = _interp_weights(generator, z.device)
    with torch.no_grad():
        z_fake = mlp_apply(nets["e"], x)
        mu, sigma_sq, _ = _g_apply(cfg, nets["g"], z, generator, train=True)
        x_fake = reparameterize(mu, sigma_sq, generator)
    dz, dx = nets["dz"], nets["dx"]
    dz_loss = (torch.mean((0.9 - critic_apply(dz, z)) ** 2)
               + torch.mean((0.1 - critic_apply(dz, z_fake)) ** 2)) / 2.0
    dx_loss = (torch.mean((0.9 - critic_apply(dx, x)) ** 2)
               + torch.mean((0.1 - critic_apply(dx, x_fake)) ** 2)) / 2.0
    d_loss = dx_loss + dz_loss
    if cfg.gamma:
        gpz = _gradient_penalty(dz, z * eps_z + z_fake * (1.0 - eps_z))
        gpx = _gradient_penalty(dx, x * eps_x + x_fake * (1.0 - eps_x))
        d_loss = d_loss + cfg.gamma * (gpz + gpx)
    params = _params(nets, ("dz", "dx"))
    opt_d = optim.adam_update(torch.autograd.grad(d_loss, params), opt_d, params, cfg.lr,
                              b1=0.5, b2=0.9)
    losses = dict(dz_loss=dz_loss, dx_loss=dx_loss, d_loss=d_loss)
    return opt_d, {k: t.detach() for k, t in losses.items()}


def _egm_gen_step(cfg: BGMConfig, nets, opt_ge, z, x, generator):
    """Joint g/e step, in place: LSGAN terms toward 0.9 for ``x_fake =
    g(z)`` and ``z_fake = e(x)``, ``10 x`` the round trips ``e(x_fake)`` and
    ``g(z_fake)`` (each g pass reparameterised), and ``alpha`` x the mean
    squared variance; g in train mode, its running statistics chained
    through the two passes and kept.  One Adam state (b1 0.5, b2 0.9) over
    g and e.  Returns ``(opt_ge, losses)``."""
    g, e = nets["g"], nets["e"]
    mu, sigma_sq, state = _g_apply(cfg, g, z, generator, train=True)
    x_fake = reparameterize(mu, sigma_sq, generator)
    reg_loss = torch.mean(sigma_sq**2)
    z_fake = mlp_apply(e, x)
    z_rec = mlp_apply(e, x_fake)
    mu2, sigma_sq2, state = _g_apply(cfg, g, z_fake, generator, train=True, state=state)
    x_rec = reparameterize(mu2, sigma_sq2, generator)

    l2_loss_x = torch.mean((x - x_rec) ** 2)
    l2_loss_z = torch.mean((z - z_rec) ** 2)
    g_loss_adv = torch.mean((0.9 - critic_apply(nets["dx"], x_fake)) ** 2)
    e_loss_adv = torch.mean((0.9 - critic_apply(nets["dz"], z_fake)) ** 2)
    g_e_loss = g_loss_adv + e_loss_adv + 10.0 * (l2_loss_x + l2_loss_z) + cfg.alpha * reg_loss
    params = _params(nets, ("g", "e"))
    opt_ge = optim.adam_update(torch.autograd.grad(g_e_loss, params), opt_ge, params, cfg.lr,
                               b1=0.5, b2=0.9)
    g.set_bn_state(state)
    losses = dict(g_loss_adv=g_loss_adv, e_loss_adv=e_loss_adv, l2_loss_z=l2_loss_z,
                  l2_loss_x=l2_loss_x, reg_loss=reg_loss, g_e_loss=g_e_loss)
    return opt_ge, {k: t.detach() for k, t in losses.items()}


def _egm_iter(cfg: BGMConfig, nets, opt_d, opt_ge, data_x, generator, batch_size,
              disc_step=_egm_disc_step, gen_step=_egm_gen_step):
    """One EGM iteration: ``g_d_freq`` critic steps, then one generator
    step; each step draws its own batch indices and batch z.  Returns
    ``(opt_d, opt_ge, losses)``.  (A model's ``egm_init`` passes its own
    two steps.)"""
    n = data_x.shape[0]
    d_losses = {}
    for _ in range(cfg.g_d_freq):
        idx, batch_z = _egm_batch(generator, n, batch_size, cfg.z_dim, data_x.device)
        opt_d, d_losses = disc_step(cfg, nets, opt_d, batch_z, data_x[idx], generator)
    idx, batch_z = _egm_batch(generator, n, batch_size, cfg.z_dim, data_x.device)
    opt_ge, g_losses = gen_step(cfg, nets, opt_ge, batch_z, data_x[idx], generator)
    return opt_d, opt_ge, {**d_losses, **g_losses}


# ---------------------------------------------------------------------------
# Imputation target
# ---------------------------------------------------------------------------


def _masked_log_prob(cfg: BGMConfig, g, z, data, mask, generator=None, draws=None):
    """``log p(z | x_obs)`` up to a constant per row, g in eval mode: the
    full per-dimension NLL times the dense observed ``mask`` (None: every
    entry observed)."""
    mu, sigma_sq, _ = _g_apply(cfg, g, z, generator, train=False, draws=draws)
    if mask is None:
        loss_px = dist.gaussian_nll_diag(data, mu, sigma_sq)
    else:
        ll = (data - mu) ** 2 / (2.0 * sigma_sq) + 0.5 * torch.log(sigma_sq)
        loss_px = torch.sum(ll * mask, dim=1)
    return -(dist.standard_normal_neg_log_prior(z) + loss_px)


class BGM:
    """Bayesian Generative Model for tabular data on one device.

    Parameters
    ----------
    params : dict
        Required keys: ``'x_dim'``, ``'z_dim'``, ``'dataset'``,
        ``'output_dir'``.  Optional keys as in :data:`DEFAULTS`, plus
        ``'lr_decay'`` (None, ``'cosine'`` or ``'linear'``: the iterative
        phase's rate over the fit call's epochs) and ``'metrics_path'``.
        ``'use_bnn'`` picks the flipout decoder; ``'alpha'`` weighs the EGM
        variance regulariser, ``'gamma'`` the critics' gradient penalty.
        ``'save_model'``: ``fit`` writes the full training state to
        ``{output_dir}/checkpoints/{dataset}/{timestamp}/ckpt-{epoch}.npz``
        at every eval epoch (the JAX package's keys, with the two generator
        states ``['gen']`` and ``['host_gen']`` in place of its key).
    timestamp : str or None
        Run timestamp (current local time if None).  When the checkpoint
        folder holds a ``ckpt-*.npz`` (of either package), its nets and the
        decoder's running statistics are restored here, and ``fit`` resumes
        from the port's own full-state file.
    random_seed : int or None
        Seed of the init and of the model's generators (default 42).
    device : str or torch.device
        ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.

    Attributes
    ----------
    nets : dict
        ``g`` (a ``VariationalMLP`` or ``FlipoutVariationalMLP``; its
        running statistics are its buffers), ``e`` (an ``MLP``), ``dz`` and
        ``dx`` (critics with frozen-BN affines).
    egm_losses, fit_losses : dict
        The last EGM iteration's and the last training step's losses, as
        floats.
    """

    # the model's steps, which MNISTBGM replaces
    _train_batch_step = staticmethod(_train_batch_step)
    _egm_iter = staticmethod(_egm_iter)
    _egm_disc_step = staticmethod(_egm_disc_step)
    _egm_gen_step = staticmethod(_egm_gen_step)

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        merged = dict(DEFAULTS)
        merged.update(params)
        self.params = merged
        p = merged
        self.device = resolve_device(device)
        self.cfg = self._make_config(p)
        self.seed = 42 if random_seed is None else int(random_seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # Host-side stream: epoch permutations and the seeds of forked
        # generators, drawn with no device round trip.
        self._host_gen = torch.Generator().manual_seed(self.seed + 1)
        self._metrics = MetricsLogger(p["metrics_path"]) if p.get("metrics_path") else None
        self._build_nets()
        self.data_z = None
        self.history_loss = []
        self.egm_losses = None
        self.fit_losses = None

        self.timestamp = timestamp
        if self.timestamp is None:
            self.timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.checkpoint_path = "{}/checkpoints/{}/{}".format(
            p["output_dir"], p["dataset"], self.timestamp)
        if p["save_model"]:
            os.makedirs(self.checkpoint_path, exist_ok=True)
        self.save_dir = "{}/results/{}/{}".format(p["output_dir"], p["dataset"], self.timestamp)
        if p["save_res"]:
            os.makedirs(self.save_dir, exist_ok=True)

        self._resume_ckpt = ckpt.latest_checkpoint(self.checkpoint_path)
        if self._resume_ckpt is not None:
            tree = bridge.npz_tree(self._resume_ckpt)
            self._copy_nets(bridge.nets_from_numpy(tree["nets"]), self._resume_ckpt,
                            tree.get("g_state"))
            print("Latest checkpoint restored!!")

    # -- construction -----------------------------------------------------

    @staticmethod
    def _make_config(p):
        return BGMConfig(
            x_dim=int(p["x_dim"]), z_dim=int(p["z_dim"]), use_bnn=bool(p["use_bnn"]),
            kl_weight=float(p["kl_weight"]), lr=float(p["lr"]), lr_theta=float(p["lr_theta"]),
            lr_z=float(p["lr_z"]), gamma=float(p["gamma"]), alpha=float(p["alpha"]),
            g_d_freq=int(p["g_d_freq"]))

    def _make_nets(self, init_gen) -> dict:
        """The four nets, drawn on the CPU from ``init_gen``."""
        cfg, p = self.cfg, self.params
        decoder = FlipoutVariationalMLP if cfg.use_bnn else VariationalMLP
        return {
            "g": decoder(cfg.z_dim, cfg.x_dim, p["g_units"], init_gen),
            "e": MLP(cfg.x_dim, cfg.z_dim, p["e_units"], init_gen),
            "dz": Critic(cfg.z_dim, p["dz_units"], init_gen),
            "dx": Critic(cfg.x_dim, p["dx_units"], init_gen),
        }

    def _build_nets(self):
        nets = self._make_nets(torch.Generator().manual_seed(self.seed))
        self.nets = {k: nets[k].to(self.device) for k in NET_NAMES}
        self.opt_g = optim.adam_init(self.nets["g"].parameters())
        self._opt_d = optim.adam_init(_params(self.nets, ("dz", "dx")))
        self._opt_ge = optim.adam_init(_params(self.nets, ("g", "e")))

    def _sub(self, names):
        return {k: self.nets[k] for k in names}

    def _copy_nets(self, nets, path, g_state=None):
        """Copy the four nets of ``nets`` (read from ``path``) into the
        model's own parameters, and ``g_state`` (JAX's form) into g's
        running statistics; kinds and dims must match this model."""
        for k in NET_NAMES:
            if k not in nets or type(nets[k]) is not type(self.nets[k]):
                raise ValueError(f"{path}: no {type(self.nets[k]).__name__} {k!r}")
            if nets[k].dims != self.nets[k].dims:
                raise ValueError(f"{path}: net {k!r} has dims {nets[k].dims}, "
                                 f"this model {self.nets[k].dims}")
        with torch.no_grad():
            for k in NET_NAMES:
                for dst, src in zip(self.nets[k].parameters(), nets[k].parameters()):
                    dst.copy_(src)
        if g_state is not None:
            self.nets["g"].set_bn_state(bridge.bn_state_from_numpy(g_state, self.device))

    def _fork_generator(self) -> torch.Generator:
        """A new device generator seeded from the host stream (no sync)."""
        seed = int(torch.randint(0, 2**62, (), generator=self._host_gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _data(self, data):
        """``data`` as a float32 tensor on the model's device."""
        return torch.as_tensor(data if torch.is_tensor(data) else np.asarray(data, np.float32),
                               dtype=torch.float32, device=self.device)

    _train_data = _data  # the fit's data on the device (MNISTBGM: images)

    @torch.no_grad()
    def _encode(self, data):
        """``e(data)``, the latent table's start after the EGM."""
        return mlp_apply(self.nets["e"], data)

    def _g_state(self):
        """g's running statistics in JAX's form (``g_state``), or None where
        g keeps none."""
        return bridge.bn_state_to_numpy(self.nets["g"])

    def get_config(self):
        """Return ``{"params": params}``."""
        return {"params": self.params}

    def save_weights(self, path: str):
        """Save the nets, g's running statistics and (if fitted) the latent
        table as the ``.npz`` JAX ``BGM.save_weights`` writes; JAX
        ``load_weights`` reads it."""
        return bridge.save_npz(path, self.nets, self.data_z, g_state=self._g_state())

    def load_weights(self, path: str):
        """Restore the nets, g's running statistics and the latent table (if
        present) from a ``save_weights`` ``.npz`` of either package; shapes
        must match this model."""
        bundle = bridge.load_npz(path)
        self._copy_nets(bundle["nets"], path, bundle.get("g_state"))
        if "data_z" in bundle:
            self.data_z = torch.as_tensor(bundle["data_z"], device=self.device)
        return self

    def initialize_nets(self, print_summary: bool = False):
        """Networks are built eagerly in ``__init__``; optionally print g's size."""
        if print_summary:
            n_params = sum(t.numel() for t in self.nets["g"].parameters())
            print(f"g_net: {n_params} parameters")

    # -- checkpointable training state --------------------------------------

    def _full_state_bundle(self, data_z, z_opt, epoch):
        """The full training state in the JAX package's schema (numpy
        leaves), with the device and host generators' states (uint8) under
        ``['gen']`` and ``['host_gen']`` where JAX keeps its PRNG key."""
        bundle = {
            "nets": bridge.nets_to_numpy(self.nets),
            "opt_g": bridge.adam_to_jax(self.opt_g, self.nets["g"]),
            "opt_d": bridge.adam_to_jax(self._opt_d, self._sub(("dz", "dx"))),
            "opt_ge": bridge.adam_to_jax(self._opt_ge, self._sub(("g", "e"))),
            "data_z": data_z.detach().cpu().numpy(),
            "z_opt": bridge.table_adam_to_jax(z_opt),
            "gen": self._gen.get_state().numpy(),
            "host_gen": self._host_gen.get_state().numpy(),
            "epoch": np.asarray(epoch, np.int32),
        }
        g_state = self._g_state()
        if g_state is not None:
            bundle["g_state"] = g_state
        return bundle

    def _apply_full_state(self, state):
        """Load a restored bundle into the model; returns ``(z_opt, epoch)``."""
        dev = self.device
        self._copy_nets(bridge.nets_from_numpy(state["nets"]), self._resume_ckpt,
                        state.get("g_state"))
        self.opt_g = bridge.adam_from_jax(state["opt_g"], self.nets["g"], dev)
        self._opt_d = bridge.adam_from_jax(state["opt_d"], self._sub(("dz", "dx")), dev)
        self._opt_ge = bridge.adam_from_jax(state["opt_ge"], self._sub(("g", "e")), dev)
        self.data_z = torch.as_tensor(state["data_z"], device=dev)
        self._gen.set_state(torch.as_tensor(state["gen"]))
        self._host_gen.set_state(torch.as_tensor(state["host_gen"]))
        return bridge.table_adam_from_jax(state["z_opt"], dev), int(state["epoch"])

    def _try_resume(self, n):
        """Restore the full training state from the checkpoint found in
        ``__init__``; returns ``(z_opt, start_epoch)`` or None.  A file
        without ``['data_z']`` returns None at once; one lacking another
        leaf of the port's bundle (a JAX full-state file has no ``['gen']``)
        prints why and returns None, and training goes on from the nets
        ``__init__`` restored."""
        if self._resume_ckpt is None or not ckpt.has_group(self._resume_ckpt, "data_z"):
            return None
        z = torch.zeros((n, self.cfg.z_dim))
        try:
            state = ckpt.restore_checkpoint(
                self._resume_ckpt, self._full_state_bundle(z, optim.table_adam_init(z), 0))
        except (KeyError, ValueError) as e:
            print(f"Full-state resume unavailable ({e}); continuing with restored weights only.")
            return None
        z_opt, epoch = self._apply_full_state(state)
        print(f"Resuming training from checkpoint at epoch {epoch}.")
        return z_opt, epoch + 1

    # -- EGM ------------------------------------------------------------------

    def egm_init(self, data, egm_n_iter=10000, batch_size=32, egm_batches_per_eval=500,
                 verbose=1, _writes=True):
        """Dual-LSGAN warm start of e and g: ``egm_n_iter + 1`` iterations,
        with a logging slot every ``egm_batches_per_eval``.  At each slot an
        evaluation generator is forked whether or not it is used; with
        ``verbose`` the slot prints the losses and the reconstruction MSE,
        with ``save_res`` it writes ``init_data_gen_at_{iter}.npz`` (unless
        ``_writes`` is false, on the ranks of a mesh other than 0; the
        draws are made all the same)."""
        data = self._train_data(data)
        print("EGM Initialization Starts ...")
        done, total = 0, egm_n_iter + 1
        losses = None
        while done < total:
            n_eval = min(egm_batches_per_eval, total - done)
            for _ in range(n_eval):
                self._opt_d, self._opt_ge, losses = self._egm_iter(
                    self.cfg, self.nets, self._opt_d, self._opt_ge, data, self._gen, batch_size,
                    disc_step=self._egm_disc_step, gen_step=self._egm_gen_step)
            done += n_eval
            eval_gen = self._fork_generator()
            if verbose:
                lv = {k: float(t) for k, t in losses.items()}
                print(
                    "EGM Initialization Iter [%d] : g_loss_adv[%.4f], e_loss_adv [%.4f], "
                    "l2_loss_z [%.4f], l2_loss_x [%.4f], sd^2_loss[%.4f], g_e_loss [%.4f], "
                    "dz_loss [%.4f], dx_loss[%.4f], d_loss [%.4f]"
                    % (done - 1, lv["g_loss_adv"], lv["e_loss_adv"], lv["l2_loss_z"],
                       lv["l2_loss_x"], lv["reg_loss"], lv["g_e_loss"],
                       lv["dz_loss"], lv["dx_loss"], lv["d_loss"]))
                mse = float(self.evaluate(data, generator=eval_gen))
                print("iter [%d/%d]: MSE_x: %.4f\n" % (done - 1, egm_n_iter, mse))
            if self.params["save_res"]:
                self._save_egm_generated(f"{self.save_dir}/init_data_gen_at_{done - 1}.npz", data,
                                         _writes)
        self.egm_losses = {k: float(t) for k, t in losses.items()}
        print("EGM Initialization Ends.")

    def _save_egm_generated(self, path, data, write=True):
        """An EGM logging slot's ``save_res`` file: :meth:`_save_generated`
        with ``e(data)``."""
        self._save_generated(path, self._encode(data).cpu().numpy(), write)

    def _save_generated(self, path, z, write=True):
        """Write two ``generate(5000)`` draws (with and without the x noise),
        their variances and ``z`` to ``path`` (with ``write``; the draws
        are made either way, so every rank of a mesh keeps its stream)."""
        gen1, var1 = self.generate(nb_samples=GEN_SAMPLES)
        gen12, var12 = self.generate(nb_samples=GEN_SAMPLES, use_x_sd=False)
        if write:
            np.savez(path, gen1=gen1, gen12=gen12, z=z, var1=var1, var12=var12)

    # -- fit ------------------------------------------------------------------

    @takes_mesh
    def fit(self, data, batch_size=32, epochs=100, epochs_per_eval=5, use_egm_init=True,
            egm_n_iter=20000, egm_batches_per_eval=500, verbose=1, mesh=None,
            egm_batch_size=None):
        """EGM warm start (optional, at ``egm_batch_size`` or
        ``batch_size``), then epochs ``0..epochs`` inclusive of iterative
        updating over a fresh permutation each, full batches only (the
        incomplete last batch is skipped; ``batch_size > n`` raises), with
        the ``params['lr_decay']`` schedule over this call's ``epochs``.

        Every ``epochs_per_eval`` epochs: :meth:`evaluate` on the latent
        table (appended to ``history_loss``, logged as an ``eval`` record),
        with ``save_res`` ``data_gen_at_{epoch}.npz``, then with
        ``save_model`` the full-state checkpoint (newest 100 kept).  The
        checkpoint comes after every draw of its epoch, so a fit resumed
        from it (same ``epochs``) is bit-equal to an uninterrupted one.

        ``mesh`` splits the data, the latent table and its moments by rank
        with g and its optimizer replicated, as :meth:`CausalBGM.fit
        <bayesgm_torch.models.causalbgm.CausalBGM.fit>` does: the EGM runs
        replicated, ``e(data)`` on each rank's rows, each minibatch is
        assembled on every rank and each rank steps its own table rows;
        rank 0 alone prints and writes files.  After the fit ``data_z``
        holds every row on every rank."""
        data = self._train_data(data)
        n = data.shape[0]
        cfg = self.cfg
        rows = None if mesh is None else mesh.rows(n)
        writes = writes_files(mesh)
        if self.params["save_res"] and writes:
            with open(f"{self.save_dir}/params.txt", "w") as f:
                f.write(str(self.params))

        resume = self._try_resume(n)
        if resume is not None:
            z_opt, start_epoch = resume
            if rows is not None:
                self.data_z = rows.take(self.data_z).contiguous()
                z_opt = optim.TableAdamState(m=rows.take(z_opt.m).contiguous(),
                                             v=rows.take(z_opt.v).contiguous(), t=z_opt.t)
        else:
            start_epoch = 0
            if use_egm_init:
                self.egm_init(data, egm_n_iter=egm_n_iter,
                              batch_size=egm_batch_size or batch_size,
                              egm_batches_per_eval=egm_batches_per_eval, verbose=verbose,
                              _writes=writes)
                print("Initialize latent variables Z with e(V)...")
                with rows_mod.split(rows):
                    self.data_z = self._encode(data if rows is None else rows.take(data))
            else:
                print("Random initialization of latent variables Z...")
                with rows_mod.split(rows):
                    self.data_z = rows_mod.draw(
                        lambda s: torch.randn(s, generator=self._gen, device=self.device),
                        (n if rows is None else rows.local, cfg.z_dim))
            z_opt = optim.table_adam_init(self.data_z)
        if rows is not None:
            data = rows.take(data)

        n_full = n // batch_size
        if n_full == 0:
            raise ValueError(f"batch_size={batch_size} exceeds n={n}; the {type(self).__name__} "
                             "fit skips incomplete batches (as the reference does).")
        self.history_loss = []
        decay = self.params.get("lr_decay")
        print("Iterative Updating Starts ...")
        g = self.nets["g"]
        for epoch in range(start_epoch, epochs + 1):
            perm = torch.randperm(n, generator=self._host_gen)
            if rows is None:
                perm = perm.to(self.device)
            scale = optim.lr_schedule_scale(decay, epoch, epochs)
            batches = [perm[b * batch_size:(b + 1) * batch_size] for b in range(n_full)]
            if rows is not None:
                batches = mesh_batches(rows, batches)
            for idx in batches:
                self.opt_g, z_opt, losses = self._train_batch_step(
                    cfg, g, self.opt_g, self.data_z, z_opt, idx, self._gen, data, scale)
            self.fit_losses = {k: float(t) for k, t in losses.items()}

            if epoch % epochs_per_eval == 0:
                with rows_mod.split(rows):
                    mse_x = float(self.evaluate(data, data_z=self.data_z))
                    data_z, z_m, z_v = (rows_mod.gather(t) for t in (self.data_z, z_opt.m,
                                                                      z_opt.v))
                self.history_loss.append(mse_x)
                if verbose:
                    print("Epoch [%d/%d]: MSE_x: %.4f\n" % (epoch, epochs, mse_x))
                if self._metrics is not None and writes:
                    self._metrics.log("eval", epoch=epoch, mse_x=mse_x)
                if self.params["save_res"]:
                    self._save_generated(f"{self.save_dir}/data_gen_at_{epoch}.npz",
                                         data_z.cpu().numpy(), writes)
                if self.params["save_model"]:
                    bundle = self._full_state_bundle(
                        data_z, optim.TableAdamState(m=z_m, v=z_v, t=z_opt.t), epoch)
                    if writes:
                        path = ckpt.save_checkpoint(self.checkpoint_path, epoch, bundle,
                                                    max_to_keep=100)
                        print(f"Saving checkpoint for epoch {epoch} at {path}")
                    if rows is not None:
                        mesh.barrier()
        if rows is not None:
            self.data_z = rows.gather(self.data_z)

    # -- evaluation / generation -----------------------------------------------

    @torch.no_grad()
    def evaluate(self, data, data_z=None, use_x_sd=True, generator=None):
        """Reconstruction MSE (a 0-d device tensor) of g in eval mode on
        ``data_z`` (default ``e(data)``), with the x noise when
        ``use_x_sd``.  ``generator`` defaults to a fresh fork of the model's
        stream.  Inside a row split (:mod:`bayesgm_torch.ops.rows`) the
        rows are this rank's and the MSE is over every rank's."""
        data = self._data(data)
        gen = self._fork_generator() if generator is None else generator
        z = mlp_apply(self.nets["e"], data) if data_z is None else self._data(data_z)
        mu, sigma_sq, _ = _g_apply(self.cfg, self.nets["g"], z, gen, train=False)
        x_pred = reparameterize(mu, sigma_sq, gen) if use_x_sd else mu
        return rows_mod.mean((data - x_pred) ** 2)

    @torch.no_grad()
    def generate(self, nb_samples=1000, use_x_sd=True):
        """Sample synthetic data from the prior: ``(x, sigma_sq)`` as numpy
        arrays ``(nb_samples, x_dim)``."""
        z = torch.randn((nb_samples, self.cfg.z_dim), generator=self._gen, device=self.device)
        mu, sigma_sq, _ = _g_apply(self.cfg, self.nets["g"], z, self._gen, train=False)
        x = reparameterize(mu, sigma_sq, self._gen) if use_x_sd else mu
        return x.cpu().numpy(), sigma_sq.cpu().numpy()

    @staticmethod
    def _imputation_diagnostics(flat_draws, miss_flat, out_shape):
        """ESS / split-R-hat of the posterior-predictive draw series at
        every missing entry (NaN elsewhere), shaped like the data."""
        ess = np.full(out_shape, np.nan, np.float64)
        rhat = np.full(out_shape, np.nan, np.float64)
        if miss_flat.any():
            d = mcmc.chain_diagnostics(flat_draws[:, miss_flat])  # (n_mcmc, n_missing)
            mask = miss_flat.reshape(out_shape)
            ess[mask] = d["ess"]
            rhat[mask] = d["rhat"]
        return dict(ess=ess, rhat=rhat)

    @torch.no_grad()
    def predict_on_posteriors(self, data_posterior_z):
        """Reparameterised decodes of posterior Z draws: ``(n_mcmc, n,
        z_dim)`` in, ``(n_mcmc, n, x_dim)`` numpy out (one g pass over all
        draws)."""
        z = self._data(data_posterior_z)
        n_mcmc, n_samples = z.shape[0], z.shape[1]
        mu, sigma_sq, _ = _g_apply(self.cfg, self.nets["g"], z.reshape(-1, self.cfg.z_dim),
                                   self._gen, train=False)
        x = reparameterize(mu, sigma_sq, self._gen)
        return x.reshape(n_mcmc, n_samples, self.cfg.x_dim).cpu().numpy()

    # -- posterior inference ----------------------------------------------------

    def _prep_obs_indices(self, data_np, ind_x1):
        """Padded ``(n, K_max)`` index and 0/1 mask tensors from ragged (one
        list per row) or shared observed-index lists."""
        n = data_np.shape[0]
        if ind_x1 is None:
            return None, None
        if (isinstance(ind_x1, (list, tuple)) and len(ind_x1) > 0
                and isinstance(ind_x1[0], (list, tuple, np.ndarray))):
            assert len(ind_x1) == n, f"len(ind_x1)={len(ind_x1)} != n_samples={n}"
            max_len = max(len(row) for row in ind_x1)
            assert max_len > 0, "No observed features"
            ind_mat = np.zeros((n, max_len), np.int64)
            mask_mat = np.zeros((n, max_len), np.float32)
            for i, row in enumerate(ind_x1):
                if len(row):
                    ind_mat[i, :len(row)] = np.asarray(row, np.int64)
                    mask_mat[i, :len(row)] = 1.0
            return (torch.as_tensor(ind_mat, device=self.device),
                    torch.as_tensor(mask_mat, device=self.device))
        arr = np.asarray(ind_x1, np.int64)
        if arr.ndim == 1:
            arr = np.broadcast_to(arr[None, :], (n, arr.shape[0]))
        elif arr.ndim != 2:
            raise ValueError("ind_x1 must be rank 1 or 2 if tensor-like.")
        return (torch.as_tensor(np.ascontiguousarray(arr), device=self.device),
                torch.ones(arr.shape, device=self.device))

    def _resolve_impute_bs(self, bs, n, n_mcmc, flat_dim, budget_bytes=2 * 2**30):
        """The predict subject-batch size: an explicit ``bs`` as given (at
        least 1); ``bs=None`` all ``n`` subjects, capped so the kept sample
        cube ``(n_mcmc, bs, flat_dim)`` f32 fits ``budget_bytes`` (2 GiB).
        The chains are independent per subject, so batching is exact."""
        if bs is not None:
            return max(1, int(bs))
        by_budget = max(1, int(budget_bytes // max(1, n_mcmc * flat_dim * 4)))
        return max(1, min(n, by_budget))

    def _prep_obs_dense_mask(self, data_np, ind_x1, width):
        """``(n, width)`` 0/1 observed mask (a device tensor) from ragged or
        shared index lists, or None.  A duplicate index counts once, where
        the gather form of :meth:`get_log_posterior` counts it twice."""
        n = data_np.shape[0]
        if ind_x1 is None:
            return None
        dense = np.zeros((n, width), np.float32)
        if (isinstance(ind_x1, (list, tuple)) and len(ind_x1) > 0
                and isinstance(ind_x1[0], (list, tuple, np.ndarray))):
            assert len(ind_x1) == n, f"len(ind_x1)={len(ind_x1)} != n={n}"
            for i, row in enumerate(ind_x1):
                if len(row):
                    dense[i, np.asarray(row, np.int64)] = 1.0
        else:
            arr = np.asarray(ind_x1, np.int64)
            if arr.ndim == 1:
                dense[:, arr] = 1.0
            elif arr.ndim == 2:
                dense[np.arange(n)[:, None], arr] = 1.0
            else:
                raise ValueError("ind_x1 must be rank 1 or 2 if tensor-like.")
        return torch.as_tensor(dense, device=self.device)

    def get_log_posterior(self, data_z, data_x, ind_x1=None, obs_mask=None, generator=None):
        """``log p(z | x_obs)`` up to a constant, shape ``(n,)``, g in eval
        mode; with ``ind_x1`` (an ``(n, K)`` index array) only the gathered
        columns count, each weighed by ``obs_mask`` where given."""
        z, x = self._data(data_z), self._data(data_x)
        gen = self._gen if generator is None else generator
        mu, sigma_sq, _ = _g_apply(self.cfg, self.nets["g"], z, gen, train=False)
        if ind_x1 is None:
            loss_px = dist.gaussian_nll_diag(x, mu, sigma_sq)
        else:
            ind = torch.as_tensor(np.asarray(ind_x1), dtype=torch.long, device=self.device)
            x_c, mu_c, s_c = (torch.gather(t, 1, ind) for t in (x, mu, sigma_sq))
            ll = (x_c - mu_c) ** 2 / (2.0 * s_c) + 0.5 * torch.log(s_c)
            if obs_mask is not None:
                ll = ll * self._data(obs_mask)
            loss_px = torch.sum(ll, dim=1)
        return -(dist.standard_normal_neg_log_prior(z) + loss_px)

    def _hmc_target(self, n: int):
        """``(log_prob, noise)`` of :meth:`tfp_mcmc_sampler`'s chain over
        ``n`` rows: ``log_prob(params, z, g)`` (g a generator; with
        ``noise(g)`` given, that draw instead), see :func:`mcmc.hmc`."""
        cfg = self.cfg
        if not cfg.use_bnn:
            def log_prob(p, z, generator):
                return _masked_log_prob(cfg, p["nets"]["g"], z, p["data"], p["mask"],
                                        generator=generator)
            return log_prob, None
        layers = self.nets["g"].layers()

        def noise(generator):
            return nn_ops._fused_flipout_draws(layers, (n, cfg.z_dim), generator)

        def log_prob(p, z, draws):
            return _masked_log_prob(cfg, p["nets"]["g"], z, p["data"], p["mask"], draws=draws)
        return log_prob, noise

    @takes_mesh
    def tfp_mcmc_sampler(self, data, ind_x1=None, n_mcmc=3000, burn_in=5000, step_size=0.01,
                         num_leapfrog_steps=10, seed=42, collect=None, mesh=None,
                         collect_p=None):
        """HMC over ``p(Z | X_obs)``: one chain per row of ``data``, from
        ``N(0, I)`` drawn with ``seed``, the step size adapted over the first
        80 % of burn-in toward 0.75 acceptance.  The target multiplies the
        full per-dimension NLL by the dense observed mask of ``ind_x1``
        (None: every entry observed).  With the flipout decoder the target
        is stochastic and ``hmc`` runs in its ``noise`` mode: one fused
        flipout draw per step for the leapfrog's gradients, another for the
        end point's value.

        Returns the ``(n_mcmc, n, z_dim)`` samples as numpy, or what
        ``collect(z, generator)`` / ``collect_p(params, z, generator)``
        (``params`` holds ``nets``, ``data`` and ``mask``) collects per kept
        step.  ``mesh`` splits the chains, the data rows and the dense mask
        by rank (each rank draws every chain's momentum and uniforms and
        keeps its own; the step size adapts on the accept probability over
        all chains); the collected rows are gathered, so every rank returns
        all of them."""
        cfg = self.cfg
        data_np = np.asarray(data, np.float32)
        n = data_np.shape[0]
        flat = data_np.reshape(n, -1)
        mask = self._prep_obs_dense_mask(flat, ind_x1, flat.shape[1])
        rows = None if mesh is None else mesh.rows(n)
        if rows is not None:
            flat = flat[rows.lo:rows.hi]
            mask = None if mask is None else rows.take(mask)
        params = {"nets": self.nets, "data": self._data(flat), "mask": mask}
        log_prob, noise = self._hmc_target(flat.shape[0])
        if collect_p is None and collect is not None:
            collect_p = lambda p, z, generator: collect(z, generator)
        init_gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad(), rows_mod.split(rows):
            init = rows_mod.draw(lambda s: torch.randn(s, generator=init_gen, device=self.device),
                                 (flat.shape[0], cfg.z_dim))
            res = mcmc.hmc(log_prob, init, self._gen, burn_in=burn_in, n_keep=n_mcmc,
                           step_size=step_size, num_leapfrog=num_leapfrog_steps,
                           collect=collect_p, params=params, noise=noise, mesh=mesh)
            print(f"HMC Acceptance Rate: {float(res.accept_rate):.4f}")
            if res.samples is None:
                return None
            samples = res.samples if rows is None else rows.gather(res.samples, axis=1)
            return samples.cpu().numpy()

    @takes_mesh
    def predict(self, data, alpha=0.05, return_samples=False, bs=None, n_mcmc=5000,
                burn_in=5000, step_size=0.01, num_leapfrog_steps=10, seed=42, mesh=None,
                return_diagnostics=False):
        """Posterior prediction with NaN-encoded missing data.

        Each subject batch (``bs``; None: all subjects under a 2 GiB cube
        budget, :meth:`_resolve_impute_bs`) runs :meth:`tfp_mcmc_sampler` on
        its observed entries; every kept step decodes the state to one
        reparameterised ``x`` draw (fresh flipout noise, then fresh x noise).
        Returns ``(imputed, intervals)``: the draws' mean at the missing
        entries and the data elsewhere, and the ``[alpha/2, 1 - alpha/2]``
        quantiles at each missing entry, ``(n, n_missing, 2)`` when every row
        misses the same columns, else a list of ``(n_missing_i, 2)`` arrays.
        ``return_samples=True`` returns the ``(n_mcmc, n, x_dim)`` draw cube
        in place of the imputed data; ``return_diagnostics=True`` appends
        ESS and split-R-hat of the draws at every missing entry
        (``(n, x_dim)``, NaN at observed entries).

        ``mesh`` splits each subject batch's chains by rank
        (:meth:`tfp_mcmc_sampler`); every rank returns the same arrays."""
        if not 0 < alpha < 1:
            raise ValueError("The significance level 'alpha' must be greater than 0 and less than 1.")
        data_np = np.asarray(data, np.float32)
        n = data_np.shape[0]
        bs = self._resolve_impute_bs(bs, n, n_mcmc, int(data_np[0].size))
        is_nan = np.isnan(data_np)
        data_clean = np.nan_to_num(data_np, nan=0.0)
        miss_flat = is_nan.reshape(n, -1)

        cubes = []
        for start in range(0, n, bs):
            end = min(start + bs, n)
            ind_x1_list = [np.where(~row)[0].tolist() for row in miss_flat[start:end]]
            cubes.append(self.tfp_mcmc_sampler(
                data=data_clean[start:end], ind_x1=ind_x1_list, n_mcmc=n_mcmc,
                burn_in=burn_in, step_size=step_size, num_leapfrog_steps=num_leapfrog_steps,
                seed=seed, collect_p=self._decode_p, mesh=mesh))
        data_x_pred_all = np.concatenate(cubes, axis=1)  # (n_mcmc, n, *data.shape[1:])
        flat_pred = data_x_pred_all.reshape(data_x_pred_all.shape[0], n, -1)

        if bool(np.all(miss_flat == miss_flat[0])):
            miss_idx = np.where(miss_flat[0])[0]
            if miss_idx.size == 0:
                pred_interval = np.zeros((n, 0, 2), np.float32)
            else:
                dim_samples = flat_pred[:, :, miss_idx]
                lower = np.quantile(dim_samples, alpha / 2.0, axis=0)
                upper = np.quantile(dim_samples, 1.0 - alpha / 2.0, axis=0)
                pred_interval = np.stack([lower, upper], axis=-1)
        else:
            pred_interval = []
            for i in range(n):
                miss_idx_i = np.where(miss_flat[i])[0]
                if miss_idx_i.size == 0:
                    pred_interval.append(np.zeros((0, 2), np.float32))
                    continue
                dim_samples_i = flat_pred[:, i, miss_idx_i]
                lower_i = np.quantile(dim_samples_i, alpha / 2.0, axis=0)
                upper_i = np.quantile(dim_samples_i, 1.0 - alpha / 2.0, axis=0)
                pred_interval.append(np.stack([lower_i, upper_i], axis=-1))

        diag = (self._imputation_diagnostics(flat_pred.reshape(flat_pred.shape[0], -1),
                                             miss_flat.reshape(-1), is_nan.shape)
                if return_diagnostics else None)
        if return_samples:
            out = (data_x_pred_all, pred_interval)
        else:
            data_imputed = np.where(is_nan, data_x_pred_all.mean(axis=0), data_clean)
            out = (data_imputed, pred_interval)
        return out + (diag,) if return_diagnostics else out

    def _decode_p(self, params, z, generator):
        """predict's per-kept-step statistic: one reparameterised ``x`` draw
        of g (eval mode, fresh flipout noise)."""
        mu, sigma_sq, _ = _g_apply(self.cfg, params["nets"]["g"], z, generator, train=False)
        return reparameterize(mu, sigma_sq, generator)
