"""CausalBGM: causal inference with a 4-way partitioned latent generative
model (port of ``bayesgm_tpu/models/causalbgm.py``).

This slice of the port trains and serves the model with flipout-BNN nets
(``use_bnn=True``, the default) or plain MLP nets (``use_bnn=False``),
continuous or binary treatment, on one device:

- ``fit``: the WGAN-GP EGM warm start (:meth:`CausalBGM.egm_init`), the
  ``e(V)`` latent init, then iterative updating — per batch, Adam steps of
  g, h and f, then a row-sparse Adam step on the latent table whose
  value-and-gradient is one kernel launch: K2,
  :func:`~bayesgm_torch.ops._pk_bnn_hosteps.make_fused_causal_logp_and_grad_bnn_hosteps`
  (BNN), or K3, :func:`~bayesgm_torch.ops._pk_plain.make_fused_causal_logp_and_grad`
  (plain); eval epochs keep the best-``mse_y`` and tail-averaged (SWA)
  snapshots;
- ``predict``: adaptive MH with the plug-in estimator.  The BNN target is
  K1, :func:`~bayesgm_torch.ops._pk_bnn_hosteps.make_fused_causal_logp_bnn_hosteps`
  (one unpaired launch for the initial state, then one paired
  ``[proposed; current]`` launch per step; with ``params['mh_window_kernel']``
  the burn-in runs in windows of 50 steps, each one launch of K5,
  :func:`~bayesgm_torch.ops._pk_bnn_inkernel.make_fused_mh_steps_bnn`);
  the plain target is K4,
  :func:`~bayesgm_torch.ops._pk_plain.make_fused_causal_logp` (one launch
  for the initial state, then one per step).  ``sampler="mala"`` runs
  adaptive MALA, each evaluation one K2 (BNN: two per step, fresh noise) or
  K3 (plain: one per step, cached) launch.

Weights come from the port's own init (``random_seed``), from ``fit``, or
from a JAX ``save_weights`` file (:meth:`CausalBGM.load_weights`);
:meth:`CausalBGM.save_weights` writes one that JAX ``load_weights`` reads.
The model runs on ``device="cuda"`` by default and raises where CUDA is
absent; ``device="cpu"`` (by name) runs the plain PyTorch versions.
"""

from __future__ import annotations

import copy
import datetime
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesgm_torch import bridge
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import mcmc, optim
from bayesgm_torch.ops._pk_bnn_hosteps import (
    make_fused_causal_logp_and_grad_bnn_hosteps,
    make_fused_causal_logp_bnn_hosteps,
)
from bayesgm_torch.ops._pk_bnn_inkernel import make_fused_mh_steps_bnn
from bayesgm_torch.ops._pk_plain import (
    make_fused_causal_logp,
    make_fused_causal_logp_and_grad,
)
from bayesgm_torch.ops._pk_util import (
    flatten_flipout_params,
    flatten_mlp_params,
    flipout_step_perturbations,
    split_flipout_flat,
)
from bayesgm_torch.ops.nn import (
    MLP,
    Critic,
    FlipoutMLP,
    _fused_flipout_draws,
    critic_apply,
    flipout_mlp_apply,
    flipout_mlp_kl,
    mlp_apply,
)
from bayesgm_torch.utils import checkpoint as ckpt
from bayesgm_torch.utils.data_io import save_data
from bayesgm_torch.utils.device import resolve_device


class CBGMConfig(NamedTuple):
    """Static configuration."""

    v_dim: int
    z_dims: tuple
    binary_treatment: bool
    use_bnn: bool
    kl_weight: float
    sigma_v: Optional[float]
    sigma_x: Optional[float]
    sigma_y: Optional[float]
    use_z_rec: float
    lr: float
    lr_theta: float
    lr_z: float
    g_d_freq: int
    deconf_weight: float = 0.0


DEFAULTS = dict(
    use_bnn=True,
    g_units=[64, 64, 64, 64, 64],
    e_units=[64, 64, 64, 64, 64],
    f_units=[64, 32, 8],
    h_units=[64, 32, 8],
    dz_units=[64, 32, 8],
    lr=2e-4,
    lr_theta=1e-4,
    lr_z=1e-4,
    g_d_freq=5,
    save_model=False,
    save_res=True,
    kl_weight=1e-4,
    use_z_rec=1.0,
)

NET_NAMES = ("g", "e", "f", "h", "dz")
MH_WINDOW = 50  # steps per K5 launch in predict's windowed burn-in


def _split_z(cfg: CBGMConfig, z):
    d0, d1, d2, _ = cfg.z_dims
    return z[..., :d0], z[..., d0 : d0 + d1], z[..., d0 + d1 : d0 + d1 + d2]


def _apply(cfg: CBGMConfig, net, x, generator, draws=None):
    """Forward through a flipout MLP (``draws`` as in ``flipout_mlp_apply``)
    or a plain MLP (no randomness)."""
    if cfg.use_bnn:
        return flipout_mlp_apply(net, x, generator, draws)
    return mlp_apply(net, x)


def _kl(cfg: CBGMConfig, net):
    return flipout_mlp_kl(net) if cfg.use_bnn else 0.0


def _sigma_sq(fixed: Optional[float], raw):
    """Fixed sigma override vs. softplus variance head."""
    if fixed is not None:
        return torch.tensor(float(fixed), dtype=torch.float32, device=raw.device) ** 2
    return dist.softplus_var(raw)


# ---------------------------------------------------------------------------
# Loss terms
# ---------------------------------------------------------------------------


def _loss_v(cfg, g_net, z, v, generator):
    """``(-log p(V|Z) batch mean + kl_weight * KL, mse_v)``."""
    out = _apply(cfg, g_net, z, generator)
    mu_v = out[:, : cfg.v_dim]
    sigma_sq_v = _sigma_sq(cfg.sigma_v, out[:, -1])
    loss_mse = torch.mean((v - mu_v) ** 2)
    loss = torch.mean(dist.gaussian_nll_iso(v, mu_v, sigma_sq_v, cfg.v_dim))
    return loss + _kl(cfg, g_net) * cfg.kl_weight, loss_mse


def _loss_x(cfg, h_net, z, x, generator):
    """``(-log p(X|Z0,Z2) batch mean + kl_weight * KL, fit term)``."""
    z0, _, z2 = _split_z(cfg, z)
    out = _apply(cfg, h_net, torch.cat([z0, z2], dim=-1), generator)
    mu_x = out[:, :1]
    if cfg.binary_treatment:
        loss_fit = torch.mean(dist.bernoulli_logits_nll(x, mu_x))
        loss = loss_fit
    else:
        sigma_sq_x = _sigma_sq(cfg.sigma_x, out[:, -1])
        loss_fit = torch.mean((x - mu_x) ** 2)
        loss = torch.mean(dist.gaussian_nll_iso(x, mu_x, sigma_sq_x, 1))
    return loss + _kl(cfg, h_net) * cfg.kl_weight, loss_fit


def _loss_y(cfg, f_net, z, x, y, generator):
    """``(-log p(Y|Z0,Z1,X) batch mean + kl_weight * KL, mse_y)``; with
    ``deconf_weight > 0`` plus that weight times the squared correlation of
    the residual ``y - mu_y`` with the centred, scaled cubic basis of x."""
    z0, z1, _ = _split_z(cfg, z)
    out = _apply(cfg, f_net, torch.cat([z0, z1, x], dim=-1), generator)
    mu_y = out[:, :1]
    sigma_sq_y = _sigma_sq(cfg.sigma_y, out[:, -1])
    loss_mse = torch.mean((y - mu_y) ** 2)
    loss = torch.mean(dist.gaussian_nll_iso(y, mu_y, sigma_sq_y, 1))
    loss = loss + _kl(cfg, f_net) * cfg.kl_weight
    if cfg.deconf_weight:
        r = (y - mu_y)[:, 0]
        rc = r - torch.mean(r)
        xs = x[:, 0]
        feats = torch.stack([xs, xs**2, xs**3], dim=1)
        fc = feats - torch.mean(feats, dim=0, keepdim=True)
        fc = fc / (torch.sqrt(torch.mean(fc**2, dim=0, keepdim=True)) + 1e-6)
        cov = torch.mean(fc * rc[:, None], dim=0)
        r2 = torch.sum(cov**2) / (torch.mean(rc**2) + 1e-6)
        loss = loss + cfg.deconf_weight * r2
    return loss, loss_mse


def _neg_log_posterior_rows(cfg, nets, z, x, y, v, generator):
    """Per-sample negative log posterior through the nets' own flipout draws
    (g, then h, then f) — the composite the kernels are held against."""
    g_out = _apply(cfg, nets["g"], z, generator)
    mu_v = g_out[:, : cfg.v_dim]
    loss_pv = dist.gaussian_nll_iso(v, mu_v, _sigma_sq(cfg.sigma_v, g_out[:, -1]), cfg.v_dim)

    z0, z1, z2 = _split_z(cfg, z)
    h_out = _apply(cfg, nets["h"], torch.cat([z0, z2], dim=-1), generator)
    mu_x = h_out[:, :1]
    if cfg.binary_treatment:
        loss_px = dist.bernoulli_logits_nll(x, mu_x)[:, 0]
    else:
        loss_px = dist.gaussian_nll_iso(x, mu_x, _sigma_sq(cfg.sigma_x, h_out[:, -1]), 1)

    f_out = _apply(cfg, nets["f"], torch.cat([z0, z1, x], dim=-1), generator)
    mu_y = f_out[:, :1]
    loss_py = dist.gaussian_nll_iso(y, mu_y, _sigma_sq(cfg.sigma_y, f_out[:, -1]), 1)

    return loss_pv + loss_px + loss_py + dist.standard_normal_neg_log_prior(z)


def _latent_loss(cfg, nets, z, x, y, v, generator):
    """Batch-mean negative log posterior: the latent update's scalar loss."""
    return torch.mean(_neg_log_posterior_rows(cfg, nets, z, x, y, v, generator))


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


def _params(nets, names):
    return [p for k in names for p in nets[k].parameters()]


def _train_batch_step(cfg: CBGMConfig, nets, opts, z_table, z_opt, idx, generator, data,
                      latent_vg=None, lr_scale=1.0):
    """One iterative-updating step, in place: g, h and f each take their own
    flipout draw and an Adam step at ``lr_theta * lr_scale``; then, with the
    updated nets, the batch's latent rows take a row-sparse Adam step at
    ``lr_z * lr_scale``.

    ``latent_vg(bz, bx, by, bv, nets, generator) -> (neg_rows, grad_rows)``
    is the fused latent value-and-gradient (K2 or K3); its gradient is that of the
    row sum, so it is divided by the batch size.  Without it the gradient is
    autograd of :func:`_latent_loss`.  Returns ``(opts, z_opt, losses)``;
    the losses are 0-d tensors on the device."""
    x, y, v = data
    bx, by, bv = x[idx], y[idx], v[idx]
    bz = z_table[idx]
    lr = cfg.lr_theta * lr_scale
    opts = dict(opts)
    losses = {}
    for name, loss_fn, args, keys in (
            ("g", _loss_v, (bz, bv), ("loss_v", "mse_v")),
            ("h", _loss_x, (bz, bx), ("loss_x", "mse_x")),
            ("f", _loss_y, (bz, bx, by), ("loss_y", "mse_y"))):
        loss, aux = loss_fn(cfg, nets[name], *args, generator)
        params = list(nets[name].parameters())
        grads = torch.autograd.grad(loss, params)
        opts[name] = optim.adam_update(grads, opts[name], params, lr)
        losses[keys[0]], losses[keys[1]] = loss.detach(), aux.detach()

    if latent_vg is not None:
        neg_rows, grad_rows = latent_vg(bz, bx, by, bv, nets, generator)
        loss_post = torch.mean(neg_rows)
        z_grads = grad_rows / bz.shape[0]  # grad of the batch-mean loss
    else:
        zr = bz.detach().requires_grad_(True)
        loss_post = _latent_loss(cfg, nets, zr, bx, by, bv, generator)
        (z_grads,) = torch.autograd.grad(loss_post, zr)
    z_opt = optim.table_adam_update_rows(z_grads, idx, z_opt, z_table, cfg.lr_z * lr_scale)
    losses["loss_postrior_z"] = loss_post.detach()
    return opts, z_opt, losses


def _interp_weight(generator, device):
    """The WGAN-GP interpolation weight: one U(0, 1) scalar per critic step."""
    return torch.rand((), generator=generator, device=device)


def _egm_batch(generator, n: int, batch_size: int, z_dim: int, device):
    """One EGM step's batch: row indices (with replacement) and N(0, I) z."""
    idx = torch.randint(0, n, (batch_size,), generator=generator, device=device)
    return idx, torch.randn((batch_size, z_dim), generator=generator, device=device)


def _egm_disc_step(cfg: CBGMConfig, nets, opt_d, z, v, generator):
    """WGAN-GP critic step in latent space, in place: Wasserstein loss plus
    10 x the gradient penalty ``(||d critic / d z_hat|| - 1)^2`` at one
    random interpolate per step (a double backward).  Returns
    ``(opt_d, losses)``."""
    eps = _interp_weight(generator, z.device)
    with torch.no_grad():
        z_fake = _apply(cfg, nets["e"], v, generator)
    z_hat = (z * eps + z_fake * (1.0 - eps)).requires_grad_(True)
    dz_net = nets["dz"]
    d_fake = critic_apply(dz_net, z_fake)
    d_real = critic_apply(dz_net, z)
    dz_loss = -torch.mean(d_real) + torch.mean(d_fake)
    (grad_z,) = torch.autograd.grad(torch.sum(critic_apply(dz_net, z_hat)), z_hat,
                                    create_graph=True)
    grad_norm = torch.sqrt(torch.sum(grad_z**2, dim=1))
    gp = torch.mean((grad_norm - 1.0) ** 2)
    d_loss = dz_loss + 10.0 * gp
    params = list(dz_net.parameters())
    opt_d = optim.adam_update(torch.autograd.grad(d_loss, params), opt_d, params, cfg.lr)
    return opt_d, dict(dz_loss=dz_loss.detach(), d_loss=d_loss.detach())


def _egm_gen_step(cfg: CBGMConfig, nets, opt_ge, z, v, x, y, generator):
    """Joint g/e/f/h generator step, in place: adversarial, roundtrip
    (``l2_loss_v``, ``use_z_rec * l2_loss_z``, the latter reaching e through
    ``z_rec = e(g(z))``), supervised x/y terms and ``0.001 x`` the mean
    squared raw variance-head outputs; one Adam state over all four nets.
    Returns ``(opt_ge, losses)``."""
    g, e, f, h = (nets[k] for k in ("g", "e", "f", "h"))
    g_out = _apply(cfg, g, z, generator)
    v_fake = g_out[:, : cfg.v_dim]
    sigma_sq_loss = torch.mean(g_out[:, -1] ** 2)
    z_enc = _apply(cfg, e, v, generator)
    z0, z1, z2 = _split_z(cfg, z_enc)

    z_rec = _apply(cfg, e, v_fake, generator)
    v_rec = _apply(cfg, g, z_enc, generator)[:, : cfg.v_dim]
    d_fake = critic_apply(nets["dz"], z_enc)

    l2_loss_v = torch.mean((v - v_rec) ** 2)
    l2_loss_z = torch.mean((z - z_rec) ** 2)
    e_loss_adv = -torch.mean(d_fake)

    f_out = _apply(cfg, f, torch.cat([z0, z1, x], dim=-1), generator)
    y_fake = f_out[:, :1]
    sigma_sq_loss = sigma_sq_loss + torch.mean(f_out[:, -1] ** 2)
    h_out = _apply(cfg, h, torch.cat([z0, z2], dim=-1), generator)
    x_fake = h_out[:, :1]
    sigma_sq_loss = sigma_sq_loss + torch.mean(h_out[:, -1] ** 2)

    if cfg.binary_treatment:
        l2_loss_x = torch.mean(dist.bernoulli_logits_nll(x, x_fake))
    else:
        l2_loss_x = torch.mean((x_fake - x) ** 2)
    l2_loss_y = torch.mean((y_fake - y) ** 2)

    g_e_loss = (e_loss_adv + (l2_loss_v + cfg.use_z_rec * l2_loss_z)
                + (l2_loss_x + l2_loss_y) + 0.001 * sigma_sq_loss)
    params = _params(nets, ("g", "e", "f", "h"))
    opt_ge = optim.adam_update(torch.autograd.grad(g_e_loss, params), opt_ge, params, cfg.lr)
    losses = dict(e_loss_adv=e_loss_adv, l2_loss_v=l2_loss_v, l2_loss_z=l2_loss_z,
                  l2_loss_x=l2_loss_x, l2_loss_y=l2_loss_y, g_e_loss=g_e_loss)
    return opt_ge, {k: t.detach() for k, t in losses.items()}


def _egm_iter(cfg: CBGMConfig, nets, opt_d, opt_ge, data, generator, batch_size):
    """One EGM iteration: ``g_d_freq`` critic steps, then one generator step;
    each step draws its own batch indices and batch z.  Returns
    ``(opt_d, opt_ge, losses)``."""
    x, y, v = data
    n, z_dim = x.shape[0], sum(cfg.z_dims)
    d_losses = {}
    for _ in range(cfg.g_d_freq):
        idx, batch_z = _egm_batch(generator, n, batch_size, z_dim, x.device)
        opt_d, d_losses = _egm_disc_step(cfg, nets, opt_d, batch_z, v[idx], generator)
    idx, batch_z = _egm_batch(generator, n, batch_size, z_dim, x.device)
    opt_ge, g_losses = _egm_gen_step(cfg, nets, opt_ge, batch_z, v[idx], x[idx], y[idx],
                                     generator)
    return opt_d, opt_ge, {**d_losses, **g_losses}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _percentile_nearest(x, pct: float):
    """``jnp.percentile(x, pct, method="nearest")``: the index is computed in
    float32 as JAX computes it, and a tie (weight exactly 0.5) takes the
    lower neighbour."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.shape[0]
    f = np.float32
    q = (f(pct) / f(100.0)) * f(n - 1)
    low = np.floor(q)
    idx = int(low) if q - low <= f(0.5) else int(np.ceil(q))
    return flat[min(max(idx, 0), n - 1)]


def _linspace(start, stop, num: int):
    """``jnp.linspace`` (endpoint included) on 0-d tensors:
    ``start * (1 - s) + stop * s`` with ``s = i / (num - 1)``, then ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


@torch.no_grad()
def _evaluate(cfg: CBGMConfig, nets, data, z, generator, nb_intervals: int = 200):
    """Full-data reconstruction MSEs and the in-sample ITE (binary) or ADRF
    grid (continuous).  Returns ``(causal_pre, mse_x, mse_y, mse_v)`` as
    device tensors.

    Draw order: e (when ``z`` is None), g, f, h, then the effect.  The ADRF
    grid (``nb_intervals`` points between the 5th and 95th 'nearest'
    percentiles of x) takes ONE flipout draw shared by every grid point,
    as JAX's vmap over one key does."""
    x, y, v = data
    if z is None:
        z = _apply(cfg, nets["e"], v, generator)
    z0, z1, z2 = _split_z(cfg, z)
    v_pred = _apply(cfg, nets["g"], z, generator)[:, : cfg.v_dim]
    y_pred = _apply(cfg, nets["f"], torch.cat([z0, z1, x], dim=-1), generator)[:, :1]
    x_pred = _apply(cfg, nets["h"], torch.cat([z0, z2], dim=-1), generator)[:, :1]
    if cfg.binary_treatment:
        x_pred = torch.sigmoid(x_pred)
    mse_v = torch.mean((v - v_pred) ** 2)
    mse_x = torch.mean((x - x_pred) ** 2)
    mse_y = torch.mean((y - y_pred) ** 2)

    f_net = nets["f"]
    if cfg.binary_treatment:
        ones = torch.ones((x.shape[0], 1), device=x.device)
        y_pos = _apply(cfg, f_net, torch.cat([z0, z1, ones], dim=-1), generator)[:, :1]
        y_neg = _apply(cfg, f_net, torch.cat([z0, z1, 0.0 * ones], dim=-1), generator)[:, :1]
        return y_pos - y_neg, mse_x, mse_y, mse_v

    x_grid = _linspace(_percentile_nearest(x, 5.0), _percentile_nearest(x, 95.0), nb_intervals)
    zz = torch.cat([z0, z1], dim=-1)
    n, d = zz.shape
    draws = _fused_flipout_draws(f_net.layers(), (n, d + 1), generator) if cfg.use_bnn else None
    chunk = max(1, min(nb_intervals, (1 << 22) // max(n, 1)))
    means = []
    for start in range(0, nb_intervals, chunk):
        xv = x_grid[start:start + chunk]
        inp = torch.cat([zz.expand(xv.shape[0], n, d),
                         xv[:, None, None].expand(xv.shape[0], n, 1)], dim=-1)
        means.append(torch.mean(_apply(cfg, f_net, inp, generator, draws)[..., 0], dim=1))
    return torch.cat(means), mse_x, mse_y, mse_v


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def _effect_collector(cfg: CBGMConfig, nets, x_values, sample_y: bool):
    """Per-kept-step MCMC statistic ``collect(z, generator)``.

    Binary treatment: per-subject ITE draw ``(n,)``.  Continuous: ADRF grid
    means ``(len(x_values),)``; every grid point gets its own weight-noise
    draw and signs (one batched ``(X, n, .)`` pass through f)."""

    def outcome(z, xv_col, generator):
        z0, z1, _ = _split_z(cfg, z)
        zz = torch.cat([z0, z1], dim=-1).expand(xv_col.shape[:-1] + (z0.shape[-1] + z1.shape[-1],))
        out = _apply(cfg, nets["f"], torch.cat([zz, xv_col], dim=-1), generator)
        mu_y = out[..., 0]
        if sample_y:
            sigma_sq = _sigma_sq(cfg.sigma_y, out[..., 1])
            noise = torch.randn(mu_y.shape, generator=generator, device=mu_y.device)
            return mu_y + torch.sqrt(sigma_sq) * noise
        return mu_y

    if cfg.binary_treatment:

        def collect(z, generator):
            ones = torch.ones((z.shape[0], 1), device=z.device)
            return outcome(z, ones, generator) - outcome(z, 0.0 * ones, generator)

    else:

        def collect(z, generator):
            xv = torch.as_tensor(np.asarray(x_values, np.float32), device=z.device)
            cols = xv[:, None, None].expand(xv.shape[0], z.shape[0], 1)
            return outcome(z, cols, generator).mean(dim=1)

    return collect


def _effect_collector_p(cfg: CBGMConfig, x_values, sample_y: bool):
    """Params-mode effect collector: the nets arrive via ``params["nets"]``."""

    def collect_p(params, z, generator):
        return _effect_collector(cfg, params["nets"], x_values, sample_y)(z, generator)

    return collect_p


def _resolve_predict_bs(cfg: CBGMConfig, bs, n_test: int) -> int:
    """Resolve the predict subject-batch size against the BNN eps contract.

    With ``use_bnn=True`` and continuous treatment the flipout eps of each
    evaluation is shared across a launch; batching subjects scopes that
    sharing per batch and narrows subject-averaged ADRF intervals.
    ``bs=None`` therefore auto-sizes to ``n_test`` in that regime (and to
    10000 otherwise); an explicit smaller ``bs`` is honored but warned about.
    """
    if bs is None:
        if cfg.use_bnn and not cfg.binary_treatment:
            return max(1, n_test)
        return 10000
    bs = max(1, int(bs))
    if cfg.use_bnn and not cfg.binary_treatment and n_test > bs:
        warnings.warn(
            f"use_bnn=True with continuous treatment and n_test={n_test} > "
            f"bs={bs}: subject batching scopes the shared flipout eps per "
            "batch, narrowing ADRF intervals vs one full-data launch. Set "
            "bs >= n_test (or leave bs=None) for reference-exact intervals.",
            UserWarning, stacklevel=3)
    return bs


class _KernelLogProb(torch.autograd.Function):
    """``log p(z)`` from a fused value-and-gradient ``run(z) -> (neg, dneg/dz)``
    (K2 or K3): the forward returns ``-neg`` and keeps the gradient, the
    backward scales it per row by the cotangent, so a value and its gradient
    cost one launch."""

    @staticmethod
    def forward(ctx, z, run):
        neg, grad_neg = run(z)
        ctx.save_for_backward(grad_neg)
        return -neg

    @staticmethod
    def backward(ctx, cotangent):
        (grad_neg,) = ctx.saved_tensors
        return -cotangent[:, None] * grad_neg, None


def _kernel_seed(generator, device):
    """Two int32 seed words for the kernel's sign generator, drawn on the
    device (no host round trip)."""
    return torch.randint(0, 2**31 - 1, (2,), generator=generator, device=device,
                         dtype=torch.int32)


class CausalBGM:
    """Causal Bayesian Generative Model (fit and predict slice).

    Parameters
    ----------
    params : dict
        Required keys: ``'v_dim'``, ``'z_dims'`` ([z0, z1, z2, z3]),
        ``'binary_treatment'``, ``'dataset'``, ``'output_dir'``.  Optional
        keys as in :data:`DEFAULTS`, plus fixed-variance overrides
        ``'sigma_v'``/``'sigma_x'``/``'sigma_y'``, ``'antithetic_eps'``,
        ``'lr_decay'`` (``'cosine'``, ``'linear'`` or None) and
        ``'use_pallas_latent'`` (``"auto"``: the kernels (K2/K3) on CUDA and
        the autograd composite on the CPU; True: the kernels' wrappers
        everywhere, which on the CPU are their plain versions; any other
        value raises ``ValueError``).  ``'use_bnn'`` (default True) picks
        flipout-BNN or plain MLP nets for g, e, h and f.
        ``'mh_window_kernel'`` (default False): with BNN nets, ``predict``'s
        MH burn-in runs in windows of 50 steps, one K5 launch each, with
        weight noise drawn per row block in the kernel (see
        :func:`~bayesgm_torch.ops.mcmc.adaptive_mh`); the kept steps stay
        per step.  With plain nets, or when ``burn_in`` is not a multiple
        of 50, the burn-in stays per step, as in the JAX package.  On the
        CPU the window runs K5's plain version (the JAX package on the CPU
        ignores the flag and runs per step).
    timestamp : str or None
        Run timestamp (current local time if None).  When
        ``{output_dir}/checkpoints/{dataset}/{timestamp}`` holds a JAX
        ``ckpt-*.npz``, the five nets of the latest one are restored here,
        as the JAX package does; ``fit`` still refuses to resume from it.
    random_seed : int or None
        Seed of the init and of the model's generators (default 42).
    device : str or torch.device
        ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.

    Attributes
    ----------
    nets : dict
        ``g``, ``h``, ``f``, ``e`` (flipout or plain MLPs) and ``dz`` (the
        critic).
    kernels : dict
        The kernel wrappers, each counting its kernel launches in
        ``launches``.  BNN nets: K1 for the MH target (``"bnn_hosteps"`` for
        the initial evaluation, ``"bnn_hosteps_paired"`` per step), K5
        (``"bnn_mh_window"``) for the windowed burn-in of
        ``mh_window_kernel``, and K2 (``"bnn_hosteps_grad"``) for fit's
        latent update and MALA.  Plain
        nets: K4 (``"plain"``) for the MH target and K3 (``"plain_grad"``)
        for fit's latent update and MALA.
    egm_losses, fit_losses : dict
        The last EGM iteration's and the last training step's losses, as
        floats (set by ``egm_init`` and after every ``fit`` epoch).
    """

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        merged = dict(DEFAULTS)
        merged.update(params)
        self.params = merged
        p = merged
        self.device = resolve_device(device)
        self.cfg = CBGMConfig(
            v_dim=int(p["v_dim"]),
            z_dims=tuple(int(d) for d in p["z_dims"]),
            binary_treatment=bool(p["binary_treatment"]),
            use_bnn=bool(p["use_bnn"]),
            kl_weight=float(p["kl_weight"]),
            sigma_v=p.get("sigma_v"),
            sigma_x=p.get("sigma_x"),
            sigma_y=p.get("sigma_y"),
            use_z_rec=float(p["use_z_rec"]),
            lr=float(p["lr"]),
            lr_theta=float(p["lr_theta"]),
            lr_z=float(p["lr_z"]),
            g_d_freq=int(p["g_d_freq"]),
            deconf_weight=float(p.get("deconf_weight", 0.0)),
        )
        if p["save_model"]:
            raise NotImplementedError("save_model (checkpointing) is not ported yet")
        if p.get("metrics_path"):
            raise NotImplementedError("metrics_path (MetricsLogger) is not ported yet")
        use_k2 = p.get("use_pallas_latent", "auto")
        if not (use_k2 is True or (isinstance(use_k2, str) and use_k2 == "auto")):
            raise ValueError(f"use_pallas_latent={use_k2!r}: only 'auto' or True (the "
                             "latent update and the MH target on CUDA always run the kernels)")
        self._kernel_path = self.device.type == "cuda" or use_k2 is True
        self.seed = 42 if random_seed is None else int(random_seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        # Host-side stream: epoch permutations and the seeds of forked
        # generators, drawn with no device round trip.
        self._host_gen = torch.Generator().manual_seed(self.seed + 1)
        self._build_nets()
        self.data_z = None
        self.best_causal_pre = None
        self.best_epoch = None
        self.best_nets = None  # snapshot of the nets at the best-mse_y eval
        self.swa_nets = None   # running mean of the eval snapshots (tail half)
        self._swa_count = 0
        self.egm_losses = None
        self.fit_losses = None

        self.timestamp = timestamp
        if self.timestamp is None:
            self.timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.checkpoint_path = "{}/checkpoints/{}/{}".format(
            p["output_dir"], p["dataset"], self.timestamp)
        self.save_dir = "{}/results/{}/{}".format(
            p["output_dir"], p["dataset"], self.timestamp)
        if p["save_res"] and not os.path.exists(self.save_dir):
            os.makedirs(self.save_dir)

        # Restore the nets of the latest checkpoint, as the JAX package does
        # whatever save_model is; the rest of its state is fit's to resume.
        latest = ckpt.latest_checkpoint(self.checkpoint_path)
        if latest is not None:
            self._copy_nets(bridge.nets_from_numpy(ckpt.read_nets(latest)), latest)
            print("Latest checkpoint restored!!")

    # -- construction -----------------------------------------------------

    def _build_nets(self):
        cfg, p = self.cfg, self.params
        init_gen = torch.Generator().manual_seed(self.seed)
        z_dim = sum(cfg.z_dims)
        d0, d1, d2, _ = cfg.z_dims
        net = FlipoutMLP if cfg.use_bnn else MLP
        nets = {
            "g": net(z_dim, cfg.v_dim + 1, p["g_units"], init_gen),
            "h": net(d0 + d2, 2, p["h_units"], init_gen),
            "f": net(d0 + d1 + 1, 2, p["f_units"], init_gen),
            "e": net(cfg.v_dim, z_dim, p["e_units"], init_gen),
            "dz": Critic(z_dim, p["dz_units"], init_gen),
        }
        self.nets = {k: nets[k].to(self.device) for k in NET_NAMES}
        self.opts = {k: optim.adam_init(self.nets[k].parameters()) for k in ("g", "f", "h")}
        self._opt_d = optim.adam_init(self.nets["dz"].parameters())
        self._opt_ge = optim.adam_init(_params(self.nets, ("g", "e", "f", "h")))
        dims = [self.nets[k].dims for k in "ghf"]
        if cfg.use_bnn:
            self.kernels = {
                "bnn_hosteps": make_fused_causal_logp_bnn_hosteps(cfg, *dims),
                "bnn_hosteps_paired": make_fused_causal_logp_bnn_hosteps(cfg, *dims,
                                                                         paired=True),
                "bnn_hosteps_grad": make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims),
                "bnn_mh_window": make_fused_mh_steps_bnn(cfg, *dims, n_steps=MH_WINDOW),
            }
        else:
            self.kernels = {"plain": make_fused_causal_logp(cfg, *dims),
                            "plain_grad": make_fused_causal_logp_and_grad(cfg, *dims)}

    def _fork_generator(self) -> torch.Generator:
        """A new device generator seeded from the host stream (no sync)."""
        seed = int(torch.randint(0, 2**62, (), generator=self._host_gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _data(self, data):
        """``(x, y, v)`` as float32 tensors on the model's device."""
        return tuple(torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a, np.float32),
                                     dtype=torch.float32, device=self.device) for a in data)

    def get_config(self):
        """Return ``{"params": params}``."""
        return {"params": self.params}

    def save_weights(self, path: str):
        """Save every net (and the latent table, if fitted) as the ``.npz``
        JAX ``CausalBGM.save_weights`` writes; JAX ``load_weights`` reads it."""
        return bridge.save_npz(path, self.nets, self.data_z)

    def load_weights(self, path: str):
        """Restore all five nets (and the latent table, if present) from a
        ``save_weights`` ``.npz`` of either package; shapes must match this
        model.  The values are copied into the model's own parameters, so
        the optimizer states stay attached."""
        bundle = bridge.load_npz(path)
        self._copy_nets(bundle["nets"], path)
        if "data_z" in bundle:
            self.data_z = torch.as_tensor(bundle["data_z"], device=self.device)
        return self

    def _copy_nets(self, nets, path):
        """Copy the five nets of ``nets`` (read from ``path``) into the
        model's own parameters; kinds and dims must match this model."""
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

    def initialize_nets(self, print_summary: bool = False):
        """Networks are built eagerly in ``__init__``; optionally print sizes."""
        if print_summary:
            for name in ("g", "f", "h"):
                n_params = sum(t.numel() for t in self.nets[name].parameters())
                print(f"{name}_net: {n_params} parameters")

    # -- EGM initialization -------------------------------------------------

    def egm_init(self, data, egm_n_iter=30000, batch_size=32, egm_batches_per_eval=500,
                 verbose=1):
        """Adversarial EGM warm start: ``egm_n_iter + 1`` iterations of
        (``g_d_freq`` critic steps + one generator step), with a logging
        slot every ``egm_batches_per_eval`` iterations.  At each slot an
        evaluation generator is forked whether or not it is used; the
        evaluation itself runs only when ``save_res`` writes its result."""
        data = self._data(data)
        print("EGM Initialization Starts ...")
        done, total = 0, egm_n_iter + 1
        losses = None
        while done < total:
            n_eval = min(egm_batches_per_eval, total - done)
            for _ in range(n_eval):
                self._opt_d, self._opt_ge, losses = _egm_iter(
                    self.cfg, self.nets, self._opt_d, self._opt_ge, data, self._gen,
                    batch_size)
            done += n_eval
            if verbose:
                lv = {k: float(t) for k, t in losses.items()}
                print(
                    "EGM Initialization Iter [%d] : e_loss_adv [%.4f], l2_loss_v [%.4f], "
                    "l2_loss_z [%.4f], l2_loss_x [%.4f], l2_loss_y [%.4f], g_e_loss [%.4f], "
                    "dz_loss [%.4f], d_loss [%.4f]"
                    % (done - 1, lv["e_loss_adv"], lv["l2_loss_v"], lv["l2_loss_z"],
                       lv["l2_loss_x"], lv["l2_loss_y"], lv["g_e_loss"],
                       lv["dz_loss"], lv["d_loss"]))
            eval_gen = self._fork_generator()
            if self.params["save_res"]:
                causal_pre, *_ = self.evaluate(data, generator=eval_gen)
                save_data(f"{self.save_dir}/causal_pre_egm_init_iter-{done - 1}.txt",
                          causal_pre.cpu().numpy())
        self.egm_losses = {k: float(t) for k, t in losses.items()}
        print("EGM Initialization Ends.")

    # -- iterative updating -------------------------------------------------

    def _build_fused_latent_vg(self):
        """The latent value-and-gradient closure ``(bz, bx, by, bv, nets,
        generator) -> (neg_rows, grad_rows)`` through K2 (BNN nets) or K3
        (plain nets), or None for the autograd composite.

        On CUDA it is always the kernel, and a kernel that fails to build or
        launch raises.  On the CPU ``params['use_pallas_latent']`` picks:
        ``"auto"`` (default) the composite, True the kernel's wrapper, i.e.
        its plain version."""
        if not self._kernel_path:
            return None
        if not self.cfg.use_bnn:
            fused_plain = self.kernels["plain_grad"]
            return lambda bz, bx, by, bv, nets, generator: fused_plain(
                bz, bx, by, bv, *(flatten_mlp_params(nets[k]) for k in "ghf"))
        fused = self.kernels["bnn_hosteps_grad"]

        def vg(bz, bx, by, bv, nets, generator):
            ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(nets[k]))
                             for k in "ghf"))
            ps = flipout_step_perturbations(sum(sigs, []), generator)
            return fused(bz, bx, by, bv, _kernel_seed(generator, bz.device), *ws, ps)

        return vg

    def fit(self, data, epochs=100, epochs_per_eval=5, batch_size=32, startoff=0,
            use_egm_init=True, egm_n_iter=30000, egm_batches_per_eval=500,
            save_format="txt", verbose=1, mesh=None, egm_batch_size=None):
        """EGM warm start (optional), then ``epochs + 1`` passes of iterative
        updating over a fresh permutation each (full batches, then the
        remainder batch), with the ``params['lr_decay']`` schedule.  Every
        ``epochs_per_eval`` epochs :meth:`evaluate` runs; its ``mse_y`` keeps
        the best snapshot (``best_nets``, ``best_causal_pre``, from epoch
        ``startoff`` on) and the tail half of training feeds the running
        mean ``swa_nets``.

        ``mesh`` and resuming from a checkpoint are not ported yet and raise
        ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError("fit(mesh=...) is not ported yet")
        if ckpt.latest_checkpoint(self.checkpoint_path) is not None:
            raise NotImplementedError(
                f"{self.checkpoint_path} holds a checkpoint; resuming is not ported yet")
        tdata = self._data(data)
        data_v = tdata[2]
        n = data_v.shape[0]
        cfg = self.cfg
        if self.params["save_res"]:
            with open(f"{self.save_dir}/params.txt", "w") as f:
                f.write(str(self.params))

        best_loss = np.inf
        if use_egm_init:
            self.egm_init(tdata, egm_n_iter=egm_n_iter,
                          batch_size=egm_batch_size or batch_size,
                          egm_batches_per_eval=egm_batches_per_eval, verbose=verbose)
            print("Initialize latent variables Z with e(V)...")
            with torch.no_grad():
                self.data_z = _apply(cfg, self.nets["e"], data_v, self._gen)
        else:
            print("Random initialization of latent variables Z...")
            self.data_z = torch.randn((n, sum(cfg.z_dims)), generator=self._gen,
                                      device=self.device)
        z_opt = optim.table_adam_init(self.data_z)

        n_full = n // batch_size
        remainder = n - n_full * batch_size
        latent_vg = self._build_fused_latent_vg()
        decay = self.params.get("lr_decay")
        print("Iterative Updating Starts ...")
        for epoch in range(0, epochs + 1):
            perm = torch.randperm(n, generator=self._host_gen).to(self.device)
            scale = optim.lr_schedule_scale(decay, epoch, epochs)
            batches = [perm[b * batch_size:(b + 1) * batch_size] for b in range(n_full)]
            if remainder:
                batches.append(perm[n_full * batch_size:])
            for idx in batches:
                self.opts, z_opt, losses = _train_batch_step(
                    cfg, self.nets, self.opts, self.data_z, z_opt, idx, self._gen, tdata,
                    latent_vg=latent_vg, lr_scale=scale)
            self.fit_losses = {k: float(t) for k, t in losses.items()}

            if epoch % epochs_per_eval == 0:
                causal_pre, mse_x, mse_y, mse_v = self.evaluate(tdata, self.data_z)
                causal_pre = causal_pre.cpu().numpy()
                mse_y = float(mse_y)
                if verbose:
                    print("Epoch [%d/%d]: MSE_x: %.4f, MSE_y: %.4f, MSE_v: %.4f\n"
                          % (epoch, epochs, float(mse_x), mse_y, float(mse_v)))
                if epoch >= startoff and mse_y < best_loss:
                    best_loss = mse_y
                    self.best_causal_pre = causal_pre
                    self.best_epoch = epoch
                    self.best_nets = copy.deepcopy(self.nets)
                if epoch >= epochs // 2:
                    self._swa_count += 1
                    if self.swa_nets is None:
                        self.swa_nets = copy.deepcopy(self.nets)
                    else:
                        w = 1.0 / self._swa_count
                        with torch.no_grad():
                            for k in NET_NAMES:
                                for a, b in zip(self.swa_nets[k].parameters(),
                                                self.nets[k].parameters()):
                                    a.add_((b - a) * w)
                if self.params["save_res"]:
                    save_data(f"{self.save_dir}/causal_pre_at_{epoch}.{save_format}",
                              causal_pre)

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, data, data_z=None, nb_intervals=200, generator=None):
        """Reconstruction MSEs and the in-sample ITE/ADRF:
        ``(causal_pre, mse_x, mse_y, mse_v)`` as device tensors.  Without
        ``data_z`` the latents are ``e(V)``.  ``generator`` defaults to a
        fresh fork of the model's stream."""
        data = self._data(data)
        if data_z is not None:
            data_z = torch.as_tensor(data_z, dtype=torch.float32, device=self.device)
        return _evaluate(self.cfg, self.nets, data, data_z,
                         self._fork_generator() if generator is None else generator,
                         nb_intervals=nb_intervals)

    # -- posterior ------------------------------------------------------------

    def get_log_posterior(self, data_x, data_y, data_v, data_z, generator=None):
        """Batched ``log p(Z | X, Y, V)`` up to a constant, shape ``(n,)``,
        through the nets' own flipout draws."""
        x, y, v, z = self._data((data_x, data_y, data_v, data_z))
        return -_neg_log_posterior_rows(self.cfg, self.nets, z, x, y, v,
                                        self._gen if generator is None else generator)

    def _make_log_prob(self, data_x, data_y, data_v, differentiable=False, nets=None):
        """Log-target over Z, ``log_prob(z, generator) -> (n,)``, through
        ``nets`` (the model's by default).

        On the kernel path (CUDA, or ``params['use_pallas_latent'] is True``)
        it is K1 with fresh eps and sign seed per call (BNN nets) or K4
        (plain nets); with ``differentiable=True`` it is K2 or K3 wrapped in
        a ``torch.autograd.Function`` whose backward scales the kernel's
        z-gradient (for K2 taken through the same weight noise) by the
        cotangent.  Elsewhere it is the autograd composite."""
        cfg = self.cfg
        nets = self.nets if nets is None else nets
        x, y, v = self._data((data_x, data_y, data_v))

        def composite_log_prob(z, generator):
            return -_neg_log_posterior_rows(cfg, nets, z, x, y, v, generator)

        if not self._kernel_path:
            return composite_log_prob
        if not cfg.use_bnn:
            flats = [flatten_mlp_params(nets[k]) for k in "ghf"]
            if not differentiable:
                fused_plain = self.kernels["plain"]
                return lambda z, generator: -fused_plain(z.detach().contiguous(), x, y, v,
                                                         *flats)
            fused_plain_vg = self.kernels["plain_grad"]
            return lambda z, generator: _KernelLogProb.apply(
                z, lambda zz: fused_plain_vg(zz.detach().contiguous(), x, y, v, *flats))
        ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(nets[k])) for k in "ghf"))
        sigs = sum(sigs, [])

        def kernel_args(z, generator):
            ps = flipout_step_perturbations(sigs, generator)
            return (z.detach().contiguous(), x, y, v, _kernel_seed(generator, z.device), *ws, ps)

        if not differentiable:
            fused = self.kernels["bnn_hosteps"]
            return lambda z, generator: -fused(*kernel_args(z, generator))

        fused_vg = self.kernels["bnn_hosteps_grad"]
        return lambda z, generator: _KernelLogProb.apply(
            z, lambda zz: fused_vg(*kernel_args(zz, generator)))

    # -- MH target ----------------------------------------------------------

    def _make_param_log_prob(self):
        """Params-mode MH target for :func:`bayesgm_torch.ops.mcmc.adaptive_mh`.

        Returns ``(lp, plp, make_params, make_multi_step)``:

        - ``lp(params, z, g) -> (n,)``: the log-posterior through K1, with a
          fresh eps draw and fresh sign seed per call (BNN nets), or through
          K4 (plain nets);
        - ``plp(params, z_prop, z_cur, g) -> (logp_prop, logp_cur)``: both
          states stacked into one paired K1 launch; eps set 0 feeds the
          proposed half and set 1 the current half, so each state sees its
          own whole-batch eps draw (the reference's two log-posterior calls
          per step).  None for plain nets: their target is deterministic, so
          the chain caches the current state's value;
        - ``make_params(nets, data, paired) -> dict``: flattened kernel
          weights (the ``(loc, sigma, b)`` flats and their split into
          weights and sigmas), the raw nets (for the collector), the data
          and, when ``paired``, the data stacked twice;
        - ``make_multi_step(K)`` (BNN nets; None for plain nets): builds
          ``multi_step(params, state, q_sd, g) -> (state, logp, counts)``,
          K steps of the MH window kernel K5 in one launch on the unpaired
          data, with a fresh device seed per launch, through the model's one
          K5 wrapper ``kernels["bnn_mh_window"]``; K must be ``MH_WINDOW``.
        """
        cfg = self.cfg
        if not cfg.use_bnn:
            fused_plain = self.kernels["plain"]

            def make_plain_params(nets, data, paired):
                x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                           for a in data)
                return {"nets": nets, "data": (x, y, v),
                        "w": tuple(flatten_mlp_params(nets[k]) for k in "ghf")}

            def plain_lp(params, z, generator):
                x, y, v = params["data"]
                return -fused_plain(z, x, y, v, *params["w"])

            return plain_lp, None, make_plain_params, None
        fused = self.kernels["bnn_hosteps"]
        fused_paired = self.kernels["bnn_hosteps_paired"]
        anti = bool(self.params.get("antithetic_eps", False))

        def make_params(nets, data, paired):
            x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                       for a in data)
            flat = tuple(flatten_flipout_params(nets[k]) for k in "ghf")
            ws, sigs = zip(*(split_flipout_flat(f) for f in flat))
            p = {"nets": nets, "data": (x, y, v), "flat": flat, "w": ws,
                 "sigs": sum(sigs, [])}
            if paired:
                p["data2"] = tuple(torch.cat([a, a], dim=0) for a in (x, y, v))
            return p

        def lp(params, z, generator):
            gw, hw, fw = params["w"]
            x, y, v = params["data"]
            ps = flipout_step_perturbations(params["sigs"], generator)
            seed = _kernel_seed(generator, z.device)
            return -fused(z, x, y, v, seed, gw, hw, fw, ps)

        def plp(params, z_prop, z_cur, generator):
            gw, hw, fw = params["w"]
            x2, y2, v2 = params["data2"]
            n = z_prop.shape[0]
            ps2 = flipout_step_perturbations(params["sigs"], generator, n_sets=2,
                                             antithetic=anti)
            seed = _kernel_seed(generator, z_prop.device)
            neg = fused_paired(torch.cat([z_prop, z_cur], dim=0), x2, y2, v2, seed,
                               gw, hw, fw, ps2)
            return -neg[:n], -neg[n:]

        fused_ms = self.kernels["bnn_mh_window"]

        def make_multi_step(K):
            if K != MH_WINDOW:
                raise ValueError(f"the MH window runs {MH_WINDOW} steps per launch, not {K}")

            def multi_step(params, state, q_sd, generator):
                x, y, v = params["data"]
                return fused_ms(state, x, y, v, _kernel_seed(generator, state.device), q_sd,
                                *params["flat"])

            return multi_step

        return lp, plp, make_params, make_multi_step

    # -- inference ----------------------------------------------------------

    def predict(self, data, alpha=0.01, n_mcmc=3000, burn_in=5000, x_values=None,
                q_sd=1.0, sample_y=True, bs=None, sampler="mh",
                use_best_nets=False, use_swa_nets=False, mesh=None,
                return_diagnostics=False, return_draws=False,
                estimator="plugin", ess_target=None):
        """Causal effects with posterior intervals from latent MCMC.

        Binary: returns (ITE mean (n,), intervals (n, 2)).  Continuous:
        (ADRF (len(x_values),), intervals (len(x_values), 2)).  The chain and
        the effect collection run on the model's device; only the collected
        effect draws come back to the host.  ``q_sd <= 0`` or None turns on
        the 0.9/1.1 proposal-sd adaptation.  ``return_diagnostics=True``
        appends ESS / split-R̂ / pooled acceptance; ``return_draws=True``
        appends the effect draw matrix (see :meth:`_aggregate_predict`).
        ``use_best_nets`` / ``use_swa_nets`` infer with ``fit``'s best-mse_y
        snapshot or its tail weight average instead of the final nets (when
        ``fit`` made one).

        ``sampler="mala"`` runs adaptive MALA (step size 0.1, adapted toward
        0.574 acceptance) on the differentiable target instead; with BNN nets
        both sides of the accept ratio are evaluated afresh every step.
        ``params['mh_window_kernel']`` runs a BNN MH burn-in in windows of
        50 steps, one K5 launch each (the class docstring says when).

        ``mesh``, ``estimator="dr"`` and ``ess_target`` are not ported yet and
        raise ``NotImplementedError``.
        """
        if not 0 < alpha < 1:
            raise ValueError("The significance level 'alpha' must be greater than 0 and less than 1.")
        if mesh is not None:
            raise NotImplementedError("predict(mesh=...) is not ported yet")
        if sampler not in ("mh", "mala"):
            raise ValueError(f"unknown sampler {sampler!r} (expected 'mh' or 'mala')")
        if estimator != "plugin":
            raise NotImplementedError(f"estimator={estimator!r} is not ported yet (only 'plugin')")
        if ess_target is not None:
            raise NotImplementedError("ess_target (ESS-adaptive chains) is not ported yet")
        cfg = self.cfg
        if not cfg.binary_treatment and x_values is None:
            raise ValueError(
                "For continuous treatment, 'x_values' must not be None. "
                "Provide a list or a single treatment value.")
        if x_values is not None:
            x_values = np.atleast_1d(np.asarray(x_values, dtype=float))

        data_x, data_y, data_v = [np.asarray(a, dtype=np.float32) for a in data]
        n_test = len(data_x)
        bs = _resolve_predict_bs(cfg, bs, n_test)
        nets = self.nets
        if use_best_nets and self.best_nets is not None:
            nets = self.best_nets
        elif use_swa_nets and self.swa_nets is not None:
            nets = self.swa_nets
        adaptive = q_sd is None or q_sd <= 0
        q0 = 1.0 if adaptive else float(q_sd)

        print("MCMC Latent Variable Sampling ...")
        lp, plp, make_params, make_multi_step = self._make_param_log_prob()
        # The K-steps-per-launch burn-in (K5), opt-in as in the JAX package.
        multi_step = (make_multi_step(MH_WINDOW)
                      if self.params.get("mh_window_kernel", False) and make_multi_step
                      else None)
        collect_p = _effect_collector_p(cfg, x_values, sample_y)
        collect = _effect_collector(cfg, nets, x_values, sample_y)

        def run_batch(bx, by, bv):
            with torch.no_grad():
                init = torch.randn((bx.shape[0], sum(cfg.z_dims)), generator=self._gen,
                                   device=self.device)
                if sampler == "mala":
                    log_prob = self._make_log_prob(bx, by, bv, differentiable=True, nets=nets)
                    res = mcmc.adaptive_mala(
                        log_prob, init, self._gen, burn_in=burn_in, n_keep=n_mcmc,
                        step_size=0.1, recompute_current=cfg.use_bnn, collect=collect)
                else:
                    params = make_params(nets, (bx, by, bv), cfg.use_bnn)
                    res = mcmc.adaptive_mh(
                        lp, init, self._gen, burn_in=burn_in, n_keep=n_mcmc, q_sd=q0,
                        adaptive=adaptive, recompute_current=cfg.use_bnn, collect=collect_p,
                        paired_log_prob_fn=plp, multi_step_fn=multi_step, params=params)
                rate = float(res.accept_rate)
                samples = res.samples.cpu().numpy()
            print(f"Final MCMC Acceptance Rate: {rate:.4f}")
            return samples, rate

        return self._aggregate_predict(run_batch, (data_x, data_y, data_v), alpha,
                                       n_mcmc, bs, x_values, return_diagnostics,
                                       return_draws=return_draws)

    def _aggregate_predict(self, run_batch, data, alpha, n_mcmc, bs, x_values,
                           return_diagnostics, return_draws=False):
        """Batch subjects through ``run_batch -> (effect_draws, accept_rate)``,
        assemble the point estimate + ``[alpha/2, 1-alpha/2]`` intervals, and
        optionally ESS / split-R̂ / pooled acceptance (per-batch chains,
        aggregated conservatively: min ESS, max R̂).  ``return_draws=True``
        appends the raw draw matrix (binary ``(n_mcmc, n_test)``, continuous
        ``(len(x_values), n_mcmc)``)."""
        data_x, data_y, data_v = data
        n_test = len(data_x)
        accept_rates = []

        if self.cfg.binary_treatment:
            ite_mean = np.zeros(n_test, np.float32)
            upper = np.zeros(n_test, np.float32)
            lower = np.zeros(n_test, np.float32)
            ess = np.zeros(n_test, np.float32) if return_diagnostics else None
            rhat = np.zeros(n_test, np.float32) if return_diagnostics else None
            draws_k = [] if return_draws else None
            for start in range(0, n_test, bs):
                end = min(start + bs, n_test)
                effects, rate = run_batch(data_x[start:end], data_y[start:end],
                                          data_v[start:end])
                accept_rates.append((rate, end - start))
                ite_mean[start:end] = effects.mean(axis=0)
                upper[start:end] = np.quantile(effects, 1 - alpha / 2, axis=0)
                lower[start:end] = np.quantile(effects, alpha / 2, axis=0)
                if return_draws:
                    draws_k.append(effects)
                if return_diagnostics:
                    d = mcmc.chain_diagnostics(effects)
                    ess[start:end] = d["ess"]
                    rhat[start:end] = d["rhat"]
            out = [ite_mean, np.stack([lower, upper], axis=1)]
            if return_diagnostics:
                out.append(dict(ess=ess, rhat=rhat,
                                accept_rate=self._pooled_rate(accept_rates)))
            if return_draws:
                t_min = min(e.shape[0] for e in draws_k)
                out.append(np.concatenate([e[:t_min] for e in draws_k], axis=1))
            return tuple(out)

        effects_k, weights = [], []
        ess_min, rhat_max = None, None
        for start in range(0, n_test, bs):
            end = min(start + bs, n_test)
            effects, rate = run_batch(data_x[start:end], data_y[start:end],
                                      data_v[start:end])
            accept_rates.append((rate, end - start))
            effects_k.append(effects)  # (n_draws, len(x_values))
            weights.append(end - start)
            if return_diagnostics:
                d = mcmc.chain_diagnostics(effects.T, axis=1)
                ess_min = d["ess"] if ess_min is None else np.minimum(ess_min, d["ess"])
                rhat_max = d["rhat"] if rhat_max is None else np.maximum(rhat_max, d["rhat"])
        t_min = min(e.shape[0] for e in effects_k)
        adrf_sums = sum(e[:t_min].T * w for e, w in zip(effects_k, weights))
        causal_effects = adrf_sums / float(sum(weights))
        adrf = causal_effects.mean(axis=1)
        upper = np.quantile(causal_effects, 1 - alpha / 2, axis=1)
        lower = np.quantile(causal_effects, alpha / 2, axis=1)
        out = [adrf, np.stack([lower, upper], axis=1)]
        if return_diagnostics:
            out.append(dict(ess=ess_min, rhat=rhat_max,
                            accept_rate=self._pooled_rate(accept_rates)))
        if return_draws:
            out.append(causal_effects)
        return tuple(out)

    @staticmethod
    def _pooled_rate(rates):
        """Subject-weighted mean acceptance over predict batches."""
        tot = sum(w for _, w in rates)
        return float(sum(r * w for r, w in rates) / max(tot, 1))
