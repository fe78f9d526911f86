"""FullMCMCCausalBGM: CausalBGM with weight-space HMC (port of
``bayesgm_tpu/models/fullmcmc.py``).

After the SGD :meth:`~bayesgm_torch.models.causalbgm.CausalBGM.fit`
(inherited; the nets are plain MLPs, so its latent update is K3),
:meth:`FullMCMCCausalBGM.run_mcmc_training` draws HMC samples of g's, h's
and f's flat weights conditioned on the fitted latent table, and
:meth:`FullMCMCCausalBGM.predict` marginalises over weight and latent
uncertainty: the latent MH chain judges both sides of each step under one
weight sample drawn that step, and each kept Z draw is paired with a random
f-weight draw.

The flat weight vector follows JAX's ``ravel_pytree`` order
(:func:`~bayesgm_torch.ops.nn.flatten_params`), so JAX's weight samples mean
the same nets here.  The HMC target and the weight-conditioned MH target are
PyTorch composites, as they are XLA composites in the JAX package: no kernel
runs in them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesgm_torch import bridge
from bayesgm_torch.models import causalbgm as cb
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import mcmc
from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops.nn import flatten_params, mlp_apply, standard_normal_log_prior
from bayesgm_torch.parallel.mesh import share_state, sum_parts, takes_mesh

INFER_CHUNK = 64  # Z draws (each with its f-weight draw) per batched f pass


def _gaussian_logprob_sum(x, mu, sigma_sq):
    """Normal log-density with its constants, summed over every entry."""
    return torch.sum(-0.5 * (x - mu) ** 2 / sigma_sq - 0.5 * torch.log(sigma_sq)
                     - 0.5 * math.log(2 * math.pi))


class FullMCMCCausalBGM(cb.CausalBGM):
    """CausalBGM with HMC over the network weights and MH over the latents.

    Same params as :class:`~bayesgm_torch.models.causalbgm.CausalBGM`; the
    nets are plain MLPs whatever ``use_bnn`` says (weight uncertainty comes
    from HMC).  ``g_net_samples``, ``h_net_samples`` and ``f_net_samples``
    hold the HMC draws as numpy ``(num_samples, D)`` arrays.
    """

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        params = dict(params)
        params["use_bnn"] = False
        super().__init__(params, timestamp=timestamp, random_seed=random_seed, device=device)
        self.g_net_samples = None
        self.h_net_samples = None
        self.f_net_samples = None
        self._unravel = {name: flatten_params(self.nets[name])[1] for name in "ghf"}

    # -- weight-space HMC ----------------------------------------------------

    def _weight_log_prob_fn(self, name, inputs, targets, likelihood, mesh=None):
        """HMC target over ``(chains, D)`` flat weights: the N(0, 1) prior
        plus the full-data likelihood of the net's outputs on ``inputs``.
        With ``mesh`` the rows are this rank's: the likelihood is a local
        sum whose value and weight gradient are summed over the ranks, and
        the prior is added once, after the reduction."""
        unravel = self._unravel[name]

        def lik(flat):
            if mesh is None:
                return likelihood(targets, mlp_apply(unravel(flat), inputs))
            return sum_parts(likelihood(targets, mlp_apply(unravel(share_state(flat, mesh)),
                                                           inputs)), mesh)

        def log_prob(flat_batch, generator):
            return torch.stack([standard_normal_log_prior(flat) + lik(flat)
                                for flat in flat_batch])

        return log_prob

    @takes_mesh
    def run_mcmc_training(self, data, num_samples=2000, num_burnin=1000, eps=1e-6,
                          step_size=1e-4, num_leapfrog=3, adaptation_rate=0.05, mesh=None):
        """HMC over g's, h's and f's weights conditioned on the fitted latent
        table, one chain per net from its fitted weights, the step size
        adapted over the first 80 % of ``num_burnin``.  Call after
        :meth:`fit`.  ``eps`` is unused (kept for the JAX signature).

        ``mesh`` splits the conditioning data and the latent table by rank;
        the weight chains are replicated, every rank drawing the same
        momenta, and the likelihood's value and gradient are summed over
        the ranks at every evaluation (see :meth:`_weight_log_prob_fn`)."""
        if self.data_z is None:
            raise RuntimeError("Call fit() before run_mcmc_training().")
        cfg = self.cfg
        data_x, data_y, data_v = self._data(data)
        z = self.data_z
        if mesh is not None:
            rows = mesh.rows(z.shape[0])
            data_x, data_y, data_v, z = (rows.take(a) for a in (data_x, data_y, data_v, z))
        z0, z1, z2 = cb._split_z(cfg, z)

        def g_likelihood(v_true, out):
            return _gaussian_logprob_sum(v_true, out[:, : cfg.v_dim],
                                         dist.softplus_var(out[:, -1:]))

        def h_likelihood(x_true, out):
            if cfg.binary_treatment:
                return -torch.sum(dist.bernoulli_logits_nll(x_true, out[:, :1]))
            return _gaussian_logprob_sum(x_true, out[:, :1], dist.softplus_var(out[:, -1:]))

        def f_likelihood(y_true, out):
            return _gaussian_logprob_sum(y_true, out[:, :1], dist.softplus_var(out[:, -1:]))

        jobs = [
            ("g", z, data_v, g_likelihood),
            ("h", torch.cat([z0, z2], dim=-1), data_x, h_likelihood),
            ("f", torch.cat([z0, z1, data_x], dim=-1), data_y, f_likelihood),
        ]
        for name, inputs, targets, lik in jobs:
            print(f"Running HMC for {name}_net...")
            flat0, _ = flatten_params(self.nets[name])
            # A sharp posterior over ~10^4 weights with a full-data
            # likelihood: start small and adapt fast, as the JAX package does.
            res = mcmc.hmc(self._weight_log_prob_fn(name, inputs, targets, lik, mesh),
                           flat0[None, :], self._gen, burn_in=num_burnin, n_keep=num_samples,
                           step_size=step_size, num_leapfrog=num_leapfrog, adapt_fraction=0.8,
                           adaptation_rate=adaptation_rate)
            setattr(self, f"{name}_net_samples", res.samples[:, 0, :].cpu().numpy())
            print(f"HMC for {name}_net finished. Acceptance rate: {float(res.accept_rate):.4f}")

    # -- the posterior over Z given sampled weights ----------------------------

    def _neg_log_posterior_with_weights(self, z, x, y, v, g_flat, h_flat, f_flat):
        """Per-row ``-log p(z | x, y, v, weights)`` up to a constant."""
        cfg = self.cfg
        z0, z1, z2 = cb._split_z(cfg, z)
        g_out = mlp_apply(self._unravel["g"](g_flat), z)
        loss_pv = dist.gaussian_nll_iso(v, g_out[:, : cfg.v_dim],
                                        dist.softplus_var(g_out[:, -1]), cfg.v_dim)
        h_out = mlp_apply(self._unravel["h"](h_flat), torch.cat([z0, z2], dim=-1))
        if cfg.binary_treatment:
            loss_px = dist.bernoulli_logits_nll(x, h_out[:, :1])[:, 0]
        else:
            loss_px = dist.gaussian_nll_iso(x, h_out[:, :1], dist.softplus_var(h_out[:, -1]), 1)
        f_out = mlp_apply(self._unravel["f"](f_flat), torch.cat([z0, z1, x], dim=-1))
        loss_py = dist.gaussian_nll_iso(y, f_out[:, :1], dist.softplus_var(f_out[:, -1]), 1)
        return loss_pv + loss_px + loss_py + dist.standard_normal_neg_log_prior(z)

    @torch.no_grad()
    def get_log_posterior(self, data_x, data_y, data_v, data_z, g_weights, h_weights,
                          f_weights):
        """``log p(Z | X, Y, V, weights)`` up to a constant, shape ``(n,)``,
        under one flat weight vector per net."""
        x, y, v, z, gw, hw, fw = self._data(
            (data_x, data_y, data_v, data_z, g_weights, h_weights, f_weights))
        return -self._neg_log_posterior_with_weights(z, x, y, v, gw, hw, fw)

    @staticmethod
    def _weight_draw(params, generator):
        """One weight triple from the sample stacks, its index drawn on the
        device."""
        stacks = params["w"]
        idx = torch.randint(0, stacks[0].shape[0], (1,), generator=generator,
                            device=stacks[0].device)
        return [s.index_select(0, idx)[0] for s in stacks]

    def _weighted_log_prob_p(self, params, z, generator):
        """MH target (params mode): ``log p(z | data, w)`` under one weight
        triple drawn for this evaluation."""
        x, y, v = params["data"]
        return -self._neg_log_posterior_with_weights(z, x, y, v,
                                                     *self._weight_draw(params, generator))

    def _weighted_paired_log_prob_p(self, params, z_prop, z_cur, generator):
        """Both sides of one MH step under ONE weight triple drawn for the
        step, as the reference draws one ``rand_idx`` per step: the two
        states go through the nets as one stacked 2n-row pass."""
        x2, y2, v2 = params["data2"]
        neg = self._neg_log_posterior_with_weights(torch.cat([z_prop, z_cur], dim=0), x2, y2, v2,
                                                   *self._weight_draw(params, generator))
        n = z_prop.shape[0]
        return -neg[:n], -neg[n:]

    def _latent_chain(self, data, burn_in, n_keep, q0, adaptive, target_rate=0.25,
                      tolerance=0.05, adjustment_interval=50, window_size=100, mesh=None):
        """Adaptive MH over Z with a weight triple drawn per step; the kept
        states stay on the device.  Returns ``(MHResult, rows)``: under a
        mesh the chains of this rank's rows (``rows``, a ``RowSplit``; None
        without a mesh), the weight index drawn on every rank alike."""
        x, y, v = self._data(data)
        rows = None if mesh is None else mesh.rows(x.shape[0])
        if rows is not None:
            x, y, v = (rows.take(a) for a in (x, y, v))
        w = tuple(torch.as_tensor(s, device=self.device)
                  for s in (self.g_net_samples, self.h_net_samples, self.f_net_samples))
        params = {"w": w, "data": (x, y, v),
                  "data2": tuple(torch.cat([a, a], dim=0) for a in (x, y, v))}
        with torch.no_grad(), rows_mod.split(rows):
            init = cb._randn_rows((x.shape[0], sum(self.cfg.z_dims)), self._gen, self.device)
            res = mcmc.adaptive_mh(
                self._weighted_log_prob_p, init, self._gen, burn_in=burn_in, n_keep=n_keep,
                q_sd=float(q0), adaptive=bool(adaptive), target_rate=target_rate,
                tolerance=tolerance, adjustment_interval=adjustment_interval,
                window_size=window_size, recompute_current=True,
                paired_log_prob_fn=self._weighted_paired_log_prob_p, params=params, mesh=mesh)
        print(f"Final MCMC Acceptance Rate: {float(res.accept_rate):.4f}")
        return res, rows

    @takes_mesh
    def metropolis_hastings_sampler(self, data, g_net_samples=None, h_net_samples=None,
                                    f_net_samples=None, initial_q_sd=1.0, q_sd=None,
                                    burn_in=5000, n_keep=3000, target_acceptance_rate=0.25,
                                    tolerance=0.05, adjustment_interval=50, adaptive_sd=None,
                                    window_size=100, mesh=None):
        """Adaptive MH over Z with a random weight triple per step (both
        sides of a step under the same one).  Weight samples given here
        (numpy ``(N, D)``, the JAX package's too) replace the stored ones.
        Returns a ``(n_keep, n, z_dim)`` numpy array.

        ``mesh`` splits the chains by rank (the weight stacks replicated,
        the per-step weight index the same on every rank); every rank
        returns all the draws."""
        for name, given in (("g", g_net_samples), ("h", h_net_samples), ("f", f_net_samples)):
            if given is not None:
                setattr(self, f"{name}_net_samples",
                        bridge.flat_weight_samples(given, self.nets[name]))
        if self.g_net_samples is None:
            raise RuntimeError("Run run_mcmc_training() first.")
        if adaptive_sd is None:
            adaptive_sd = q_sd is None or q_sd <= 0
        q0 = initial_q_sd if adaptive_sd else q_sd
        res, rows = self._latent_chain(data, burn_in, n_keep, q0, adaptive_sd,
                                       target_rate=target_acceptance_rate, tolerance=tolerance,
                                       adjustment_interval=adjustment_interval,
                                       window_size=window_size, mesh=mesh)
        samples = res.samples if rows is None else rows.gather(res.samples, axis=1)
        return samples.cpu().numpy()

    def _effect_draws(self, z, f_flat, xv, sample_y):
        """Effects of K paired draws in one batched pass through K f-nets:
        ``z`` ``(K, n, z_dim)``, ``f_flat`` ``(K, D)``, treatment values
        ``xv`` ``(X,)``.  Binary (``xv = [1, 0]``): ``(K, n)`` ITE draws;
        continuous: ``(K, X)`` ADRF draws.  Inside a row split
        (:mod:`bayesgm_torch.ops.rows`) ``z`` holds this rank's rows and the
        draws are every rank's."""
        k, n, _ = z.shape
        z0, z1, _ = cb._split_z(self.cfg, z)
        zz = torch.cat([z0, z1], dim=-1)
        n_x, d = xv.shape[0], zz.shape[-1]
        inp = torch.cat([zz[:, None].expand(k, n_x, n, d),
                         xv[None, :, None, None].expand(k, n_x, n, 1)], dim=-1)
        out = mlp_apply(self._unravel["f"](f_flat), inp.reshape(k, n_x * n, d + 1))
        out = out.reshape(k, n_x, n, -1)
        y = out[..., 0]
        if sample_y:
            noise = rows_mod.draw(lambda s: torch.randn(s, generator=self._gen, device=y.device),
                                  y.shape, axis=-1)
            y = y + torch.sqrt(dist.softplus_var(out[..., 1])) * noise
        if self.cfg.binary_treatment:
            return rows_mod.gather(y[:, 0] - y[:, 1], axis=1)
        return rows_mod.mean(y, dim=2)

    def infer_from_latent_posterior(self, data_posterior_z, f_net_weights=None,
                                    x_values=None, sample_y=True):
        """Effect draws from paired (Z draw, f-weight draw) samples: binary
        ``(n_keep, n)`` ITE draws, continuous ``(n_keep, len(x_values))`` ADRF
        draws.  Without ``f_net_weights`` each Z draw gets a random one of the
        stored f samples.  The draws go through f in chunks of 64, each one
        batched matmul per layer."""
        cfg = self.cfg
        if not cfg.binary_treatment and x_values is None:
            raise ValueError("For continuous treatment, 'x_values' must not be None. "
                             "Provide a list or a single treatment value.")
        dev = self.device
        z_draws = torch.as_tensor(np.asarray(data_posterior_z, np.float32)
                                  if not torch.is_tensor(data_posterior_z) else data_posterior_z,
                                  dtype=torch.float32, device=dev)
        if f_net_weights is None:
            f_s = torch.as_tensor(self.f_net_samples, device=dev)
            idx = torch.randint(0, f_s.shape[0], (z_draws.shape[0],), generator=self._gen,
                                device=dev)
            f_w = f_s.index_select(0, idx)
        else:
            f_w = torch.as_tensor(bridge.flat_weight_samples(f_net_weights, self.nets["f"]),
                                  device=dev)
        xv = ([1.0, 0.0] if cfg.binary_treatment
              else np.atleast_1d(np.asarray(x_values, np.float32)))
        xv = torch.as_tensor(np.asarray(xv, np.float32), device=dev)
        with torch.no_grad():
            outs = [self._effect_draws(z_draws[s:s + INFER_CHUNK], f_w[s:s + INFER_CHUNK], xv,
                                       sample_y)
                    for s in range(0, z_draws.shape[0], INFER_CHUNK)]
        return torch.cat(outs).cpu().numpy()

    @takes_mesh
    def predict(self, data, alpha=0.01, n_mcmc=3000, burn_in=5000, x_values=None,
                q_sd=1.0, sample_y=True, bs=10000, return_diagnostics=False, mesh=None):
        """Causal effects marginalising over weight and latent uncertainty:
        binary ``(ITE mean (n,), intervals (n, 2))``, continuous ``(ADRF
        (len(x_values),), intervals (len(x_values), 2))``.  One chain runs
        over every subject (``bs`` is accepted for the common interface and
        not used, as in the JAX package).  ``return_diagnostics=True``
        appends ESS and split-R̂ of the effect draw series (the paired
        weight and latent chain).  There is no ``ess_target``.

        ``mesh`` splits the latent chains by rank
        (:meth:`metropolis_hastings_sampler`) and maps each rank's draws to
        effects on its rows, reduced over the ranks: every rank returns the
        same arrays."""
        if not 0 < alpha < 1:
            raise ValueError("The significance level 'alpha' must be greater than 0 and less than 1.")
        if self.f_net_samples is None:
            raise RuntimeError("Run run_mcmc_training() first.")
        if not self.cfg.binary_treatment and x_values is None:
            raise ValueError("For continuous treatment, 'x_values' must not be None. "
                             "Provide a list or a single treatment value.")
        print("MCMC Latent Variable Sampling ...")
        adaptive = q_sd is None or q_sd <= 0
        res, rows = self._latent_chain(data, burn_in, n_mcmc, 1.0 if adaptive else q_sd,
                                       adaptive, mesh=mesh)
        with rows_mod.split(rows):
            effects = self.infer_from_latent_posterior(res.samples, x_values=x_values,
                                                       sample_y=sample_y)
        point = effects.mean(axis=0)
        upper = np.quantile(effects, 1 - alpha / 2, axis=0)
        lower = np.quantile(effects, alpha / 2, axis=0)
        if return_diagnostics:
            return point, np.stack([lower, upper], axis=1), mcmc.chain_diagnostics(effects)
        return point, np.stack([lower, upper], axis=1)
