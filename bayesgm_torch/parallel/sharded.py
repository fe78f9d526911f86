"""The full-batch CausalBGM training step and the sharded MH predict over a
mesh (port of ``bayesgm_tpu/parallel/sharded.py``).

- **Full-batch step**: all ``n`` samples form one batch whose rows are split
  by rank; the nets are replicated.  Each of g, h and f takes the local sum
  of its per-row loss over the global count; the value and the gradient
  are summed over the ranks (one all-reduce), the replicated KL term is
  added once, and every rank takes the same Adam step.  The latent table
  and its Adam moments are split with the data and their dense update is
  row-local (no communication).
- **Sharded MH predict**: chains are per sample, so the chain state splits
  on rows; the only traffic is the acceptance mean that drives the
  adaptive proposal sd and the effect reductions.
"""

from __future__ import annotations

import torch

from bayesgm_torch.models import causalbgm as cb
from bayesgm_torch.ops import mcmc, optim
from bayesgm_torch.ops import rows as rows_mod


def _local_terms(cfg, name, net, z, x, y, v, generator):
    """``(per-row NLL, replicated extra)`` of g's, h's or f's loss on this
    rank's rows (``causalbgm._loss_v``, ``_loss_x`` and ``_loss_y`` average
    the NLL); the extra is the KL term and, for f with ``deconf_weight``,
    the deconfounding penalty, whose means are over every rank's rows."""
    extra = cb._kl(cfg, net) * cfg.kl_weight
    if name == "g":
        return cb._nll_rows_v(cfg, net, z, v, generator)[0], extra
    if name == "h":
        return cb._nll_rows_x(cfg, net, z, x, generator)[0], extra
    nll, mu_y = cb._nll_rows_y(cfg, net, z, x, y, generator)
    if cfg.deconf_weight:
        extra = extra + cfg.deconf_weight * cb._deconf_penalty(x, y, mu_y)
    return nll, extra


def _net_step(cfg, rows, name, net, opt, z, x, y, v, generator, lr):
    """One Adam step of ``net`` on the full-batch loss; returns ``(opt,
    loss)``, the loss summed over the ranks.

    Each rank's part of the loss is its rows' NLL sum over ``n`` plus
    ``1 / W`` of the replicated extra; the gradient of the parts and their
    values are summed over the ranks in one all-reduce (the means inside
    the extra sum their gradients over the ranks too), so every rank steps
    the same full gradient."""
    params = list(net.parameters())
    nll, extra = _local_terms(cfg, name, net, z, x, y, v, generator)
    part = torch.sum(nll) / rows.n + extra / rows.mesh.size
    grads = torch.autograd.grad(part, params)
    flat = rows.mesh.all_reduce_(torch.cat([part.detach().reshape(1)]
                                           + [g.reshape(-1) for g in grads]))
    sizes = [p.numel() for p in params]
    grads = [g.view_as(p) for g, p in zip(torch.split(flat[1:], sizes), params)]
    return optim.adam_update(grads, opt, params, lr), flat[0]


def make_sharded_causal_train_step(cfg, mesh, axis_name: str = "data"):
    """A full-data CausalBGM training step over ``mesh``.

    Returns ``step(nets, opts, z_table, z_opt, data, generator) -> (nets,
    opts, z_table, z_opt, losses)``: ``data = (x, y, v)``, ``z_table`` and
    ``z_opt``'s moments hold this rank's rows (:func:`~bayesgm_torch.parallel.shard_rows`),
    the nets and the optimizers are replicated, and ``generator`` is the
    same stream on every rank.  The nets, the table and the moments are
    updated in place and returned.  ``losses`` (``loss_v``, ``loss_x``,
    ``loss_y``, ``loss_postrior_z``) are 0-d tensors, the same on every
    rank.  The latent update uses the g, h and f of this step's Adam
    steps, as JAX's does."""

    def step(nets, opts, z_table, z_opt, data, generator):
        x, y, v = data
        rows = mesh.rows_of(z_table.shape[0])
        opts = dict(opts)
        losses = {}
        with rows.split():
            for name, key in (("g", "loss_v"), ("h", "loss_x"), ("f", "loss_y")):
                opts[name], losses[key] = _net_step(cfg, rows, name, nets[name], opts[name],
                                                    z_table, x, y, v, generator, cfg.lr_theta)
            zr = z_table.detach().requires_grad_(True)
            rows_loss = cb._neg_log_posterior_rows(cfg, nets, zr, x, y, v, generator)
            (z_grads,) = torch.autograd.grad(torch.sum(rows_loss) / rows.n, zr)
            losses["loss_postrior_z"] = rows_mod.sum_rows(rows_loss.detach()) / rows.n
        z_opt = _dense_table_adam(z_grads, z_opt, z_table, cfg.lr_z)
        return nets, opts, z_table, z_opt, losses

    return step


@torch.no_grad()
def _dense_table_adam(grads, state, table, lr, b1=0.9, b2=0.99):
    """Dense Adam on every row of the table (JAX's full-batch form:
    ``m = 0.9 m + 0.1 g`` on every row), in place."""
    t = state.t + 1
    state.m.mul_(b1).add_((1 - b1) * grads)
    state.v.mul_(b2).add_((1 - b2) * grads * grads)
    table.sub_(optim._lr_t(lr, t, b1, b2) * state.m / (torch.sqrt(state.v) + optim.EPS))
    return optim.TableAdamState(m=state.m, v=state.v, t=t)


def make_sharded_mh_predict(cfg, mesh, nets, data, x_values=None, sample_y=True,
                            axis_name: str = "data"):
    """Sharded adaptive-MH posterior inference: the chains split on rows.

    ``data`` holds this rank's rows.  Returns ``run(generator, burn_in,
    n_keep, q_sd) -> MHResult`` whose samples are the effect draws, the
    same on every rank: ITE draws ``(n_keep, n)`` for binary treatment or
    ADRF grid draws ``(n_keep, len(x_values))`` for continuous.  The
    initial state is drawn for every row on every rank and sliced."""
    x, y, v = data
    collect = cb._effect_collector(cfg, nets, x_values, sample_y)

    def log_prob(params, z, generator):
        return -cb._neg_log_posterior_rows(cfg, nets, z, x, y, v, generator)

    @torch.no_grad()
    def run(generator, burn_in=5000, n_keep=3000, q_sd=1.0):
        rows = mesh.rows_of(x.shape[0])
        with rows.split():
            init = cb._randn_rows((rows.local, sum(cfg.z_dims)), generator, x.device)
        return mcmc.adaptive_mh(log_prob, init, generator, burn_in=burn_in, n_keep=n_keep,
                                q_sd=q_sd, recompute_current=cfg.use_bnn,
                                collect=lambda params, z, g: collect(z, g), mesh=mesh)

    return run

