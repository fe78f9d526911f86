"""IdentifiableCausalBGM: the iVAE-style identifiable CausalBGM (port of
``bayesgm_tpu/models/identifiable.py``).

An auxiliary one-hot segment variable ``U`` and a conditional latent prior
``Z | U ~ N(mu(U), sigma^2(U) I)`` from a ``prior_net`` replace the N(0, I)
prior; the latent update is a joint E-step (gradient on the Z rows) and
M-step (Adam on the prior net) from one loss evaluation.

The latent loss and the MH target are the composite
:func:`~bayesgm_torch.models.causalbgm._neg_log_posterior_rows` with the
prior swapped, as they are XLA composites in the JAX package: no kernel
runs in them.  ``evaluate`` returns a 7-tuple, ``fit`` skips the incomplete
last batch and writes no metrics log, and ``predict`` forwards ``burn_in``
to the sampler, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesgm_torch import bridge
from bayesgm_torch.models import causalbgm as cb
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import mcmc, optim
from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops.nn import MLP, FlipoutMLP, flipout_mlp_kl
from bayesgm_torch.parallel.mesh import mesh_batches, takes_mesh, writes_files


def _prior_apply(cfg, prior_net, u, generator):
    """``(mu_z (n, z_dim), sigma_sq_z (n, 1))`` of the conditional prior."""
    out = cb._apply(cfg, prior_net, u, generator)
    return out[:, : sum(cfg.z_dims)], dist.softplus_var(out[:, -1:])


def _conditional_prior_nll(cfg, prior_net, z, u, generator):
    """``-log N(z; mu(u), sigma^2(u) I)`` per row, up to a constant."""
    mu_z, sigma_sq_z = _prior_apply(cfg, prior_net, u, generator)
    s = sigma_sq_z[:, 0]
    return torch.sum((z - mu_z) ** 2, dim=1) / (2.0 * s) + sum(cfg.z_dims) * torch.log(s) / 2.0


def _neg_log_posterior_rows_u(cfg, nets, prior_net, z, x, y, v, u, generator):
    """Per-row ``-log p(z | x, y, v, u)``: the likelihood rows (draws g, h,
    f) with the conditional prior (one draw of the prior net) in place of
    N(0, I)."""
    rows = cb._neg_log_posterior_rows(cfg, nets, z, x, y, v, generator)
    rows = rows - dist.standard_normal_neg_log_prior(z)
    return rows + _conditional_prior_nll(cfg, prior_net, z, u, generator)


def _ivae_latent_loss(cfg, nets, prior_net, z, x, y, v, u, generator, kl_weight):
    """The batch-mean posterior loss with the conditional prior, plus the
    prior net's KL for flipout nets."""
    loss = torch.mean(_neg_log_posterior_rows_u(cfg, nets, prior_net, z, x, y, v, u, generator))
    if cfg.use_bnn:
        loss = loss + flipout_mlp_kl(prior_net) * kl_weight
    return loss


def _ivae_train_batch_step(cfg, kl_weight, nets, opts, prior_net, prior_opt, z_table, z_opt,
                           idx, generator, data, data_u, lr_scale=1.0):
    """One training step, in place: g, h and f as in
    :func:`~bayesgm_torch.models.causalbgm._train_batch_step`, then one
    evaluation of the latent loss whose two gradients step the batch's Z
    rows (row-sparse Adam at ``lr_z * lr_scale``) and the prior net (Adam at
    ``lr_theta * lr_scale``).  Returns ``(opts, prior_opt, z_opt, losses)``.
    ``idx`` may be a mesh minibatch, as in
    :func:`~bayesgm_torch.models.causalbgm._train_batch_step`."""
    bz, bx, by, bv, bu = optim.rows_at(idx, z_table, *data, data_u)
    lr_th = cfg.lr_theta * lr_scale
    opts, losses = cb._update_nets(cfg, nets, opts, bz, bx, by, bv, generator, lr_th)
    zr = bz.detach().requires_grad_(True)
    prior_params = list(prior_net.parameters())
    loss_post = _ivae_latent_loss(cfg, nets, prior_net, zr, bx, by, bv, bu, generator, kl_weight)
    z_grads, *prior_grads = torch.autograd.grad(loss_post, [zr, *prior_params])
    z_opt = optim.table_adam_update_batch(z_grads, idx, z_opt, z_table, cfg.lr_z * lr_scale)
    prior_opt = optim.adam_update(prior_grads, prior_opt, prior_params, lr_th)
    losses["loss_postrior_z"] = loss_post.detach()
    return opts, prior_opt, z_opt, losses


class IdentifiableCausalBGM(cb.CausalBGM):
    """Identifiable CausalBGM through an auxiliary segment variable U.

    Extra optional params: ``'n_segments'`` (10) and ``'prior_units'``
    ([64]), the prior net's hidden widths; it maps a one-hot U to
    ``z_dim + 1`` outputs (the mean and a scalar variance head) and is a
    flipout or a plain MLP as the other nets are.  ``data_u`` holds the
    training rows' segments after :meth:`fit`.
    """

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        params = dict(params)
        params.setdefault("n_segments", 10)
        params.setdefault("prior_units", [64])
        self.data_u = None
        super().__init__(params, timestamp=timestamp, random_seed=random_seed, device=device)

    def _build_nets(self):
        super()._build_nets()
        p, z_dim = self.params, sum(self.cfg.z_dims)
        net = FlipoutMLP if self.cfg.use_bnn else MLP
        self.prior_net = net(p["n_segments"], z_dim + 1, p["prior_units"],
                             self._host_gen).to(self.device)
        self._prior_opt = optim.adam_init(self.prior_net.parameters())

    def _sample_u(self, n):
        """One-hot random segments ``(n, n_segments)``, from the model's
        device generator."""
        k = self.params["n_segments"]
        seg = torch.randint(0, k, (n,), generator=self._gen, device=self.device)
        return torch.nn.functional.one_hot(seg, k).to(torch.float32)

    # -- checkpointable training state ----------------------------------------

    def _copy_prior_net(self, tree, path):
        """Copy the prior net's JAX pytree ``tree`` (read from ``path``) into
        the model's own prior net; kind and dims must match."""
        prior = bridge.net_from_numpy(tree)
        if type(prior) is not type(self.prior_net) or prior.dims != self.prior_net.dims:
            raise ValueError(f"{path}: no {type(self.prior_net).__name__} prior net of dims "
                             f"{self.prior_net.dims}")
        with torch.no_grad():
            for dst, src in zip(self.prior_net.parameters(), prior.parameters()):
                dst.copy_(src)

    def _restore_nets(self, path):
        """The five nets and the prior net of a checkpoint (either package's);
        a file without ``['prior_net']`` raises ``KeyError``, as in JAX."""
        super()._restore_nets(path)
        tree = bridge.npz_tree(path)
        if "prior_net" not in tree:
            raise KeyError(f"Checkpoint {path} has no ['prior_net'] group")
        self._copy_prior_net(tree["prior_net"], path)

    def _full_state_bundle(self, data_z, z_opt, epoch, best_loss, best_causal_pre):
        bundle = super()._full_state_bundle(data_z, z_opt, epoch, best_loss, best_causal_pre)
        bundle["prior_net"] = bridge.net_to_numpy(self.prior_net)
        bundle["prior_opt"] = bridge.adam_to_jax(self._prior_opt, self.prior_net)
        data_u = None if self.data_u is None else rows_mod.gather(self.data_u)
        bundle["data_u"] = (np.zeros((data_z.shape[0], self.params["n_segments"]), np.float32)
                            if data_u is None else data_u.cpu().numpy())
        return bundle

    def _full_state_template(self, n):
        tmpl = super()._full_state_template(n)
        tmpl["data_u"] = np.zeros((n, self.params["n_segments"]), np.float32)
        return tmpl

    def _apply_full_state(self, state):
        dev = self.device
        self._copy_prior_net(state["prior_net"], self._resume_ckpt)
        self._prior_opt = bridge.adam_from_jax(state["prior_opt"], self.prior_net, dev)
        self.data_u = torch.as_tensor(state["data_u"], device=dev)
        return super()._apply_full_state(state)

    # -- fit --------------------------------------------------------------------

    @takes_mesh
    def fit(self, data, batch_size=32, epochs=100, epochs_per_eval=5, startoff=0,
            use_egm_init=True, egm_n_iter=30000, egm_batches_per_eval=500, verbose=1,
            save_format="txt", mesh=None, egm_batch_size=None):
        """Draw U for the training rows, then train as
        :meth:`CausalBGM.fit <bayesgm_torch.models.causalbgm.CausalBGM.fit>`
        does (EGM warm start, ``e(V)`` or random latent init, ``epochs + 1``
        passes with the ``lr_decay`` schedule, best and SWA snapshots,
        full-state checkpoints and exact resume), with the joint latent and
        prior-net update of :func:`_ivae_train_batch_step`.  Each pass runs
        the full batches only, skipping the incomplete last one as the
        reference does, so ``batch_size > n`` raises ``ValueError``.  No
        metrics log is written.

        ``mesh`` splits the data, U, the latent table and its moments by
        rank, with the nets, the prior net and their optimizers replicated,
        as :meth:`CausalBGM.fit
        <bayesgm_torch.models.causalbgm.CausalBGM.fit>` does; U is drawn for
        all rows on every rank.  After the fit ``data_z`` and ``data_u``
        hold every row on every rank."""
        tdata = self._data(data)
        data_v = tdata[2]
        n = data_v.shape[0]
        cfg = self.cfg
        n_full = n // batch_size
        if n_full == 0:
            raise ValueError(f"batch_size={batch_size} exceeds n={n}; the identifiable fit "
                             "skips incomplete batches (as the reference does), so no "
                             "updates would run.")
        rows = None if mesh is None else mesh.rows(n)
        if self.params["save_res"] and writes_files(mesh):
            with open(f"{self.save_dir}/params.txt", "w") as f:
                f.write(str(self.params))

        resume = self._try_resume(n)
        if resume is not None:
            z_opt, start_epoch, best_loss = resume
            if rows is not None:
                self.data_z, z_opt = self._local_table(rows, self.data_z, z_opt)
        else:
            start_epoch, best_loss = 0, np.inf
            print(f"Generating auxiliary variable U for {self.params['n_segments']} segments.")
            self.data_u = self._sample_u(n)
            if use_egm_init:
                self.egm_init(tdata, egm_n_iter=egm_n_iter,
                              batch_size=egm_batch_size or batch_size,
                              egm_batches_per_eval=egm_batches_per_eval, verbose=verbose,
                              _writes=writes_files(mesh))
                print("Initialize latent variables Z with e(V)...")
                with torch.no_grad(), rows_mod.split(rows):
                    v_rows = data_v if rows is None else rows.take(data_v)
                    self.data_z = cb._apply(cfg, self.nets["e"], v_rows, self._gen)
            else:
                print("Random initialization of latent variables Z...")
                with rows_mod.split(rows):
                    self.data_z = cb._randn_rows((n if rows is None else rows.local,
                                                  sum(cfg.z_dims)), self._gen, self.device)
            z_opt = optim.table_adam_init(self.data_z)
        if rows is not None:
            tdata = tuple(rows.take(a) for a in tdata)
            self.data_u = rows.take(self.data_u)

        kl_weight = float(self.params["kl_weight"])
        decay = self.params.get("lr_decay")
        print("Iterative Updating Starts ...")
        for epoch in range(start_epoch, epochs + 1):
            perm = torch.randperm(n, generator=self._host_gen)
            if rows is None:
                perm = perm.to(self.device)
            scale = optim.lr_schedule_scale(decay, epoch, epochs)
            batches = [perm[b * batch_size:(b + 1) * batch_size] for b in range(n_full)]
            if rows is not None:
                batches = mesh_batches(rows, batches)
            for idx in batches:
                self.opts, self._prior_opt, z_opt, losses = _ivae_train_batch_step(
                    cfg, kl_weight, self.nets, self.opts, self.prior_net, self._prior_opt,
                    self.data_z, z_opt, idx, self._gen, tdata, self.data_u, lr_scale=scale)
            self.fit_losses = {k: float(t) for k, t in losses.items()}

            if epoch % epochs_per_eval == 0:
                with rows_mod.split(rows):
                    causal_pre, mse_x, mse_y, mse_v, *_ = self.evaluate(tdata, self.data_z)
                causal_pre = causal_pre.cpu().numpy()
                mse_y = float(mse_y)
                if verbose:
                    print("Epoch [%d/%d]: MSE_x: %.4f, MSE_y: %.4f, MSE_v: %.4f\n"
                          % (epoch, epochs, float(mse_x), mse_y, float(mse_v)))
                best_loss = self._record_eval(epoch, epochs, startoff, causal_pre, mse_y,
                                              best_loss, z_opt, save_format, rows)
        if rows is not None:
            self.data_z, self.data_u = rows.gather(self.data_z), rows.gather(self.data_u)

    def evaluate(self, data, data_z=None, nb_intervals=200, generator=None):
        """``(causal_pre, mse_x, mse_y, mse_v, x_pred, y_pred, v_pred)`` as
        device tensors (the 7-tuple the reference's ``fit`` unpacks)."""
        data = self._data(data)
        if data_z is not None:
            data_z = torch.as_tensor(data_z, dtype=torch.float32, device=self.device)
        return cb._evaluate(self.cfg, self.nets, data, data_z,
                            self._fork_generator() if generator is None else generator,
                            nb_intervals=nb_intervals, with_preds=True)

    # -- posterior --------------------------------------------------------------

    @torch.no_grad()
    def get_log_posterior(self, data_x, data_y, data_v, data_z, data_u, generator=None):
        """``log p(Z | X, Y, V, U)`` with the conditional prior, up to a
        constant, shape ``(n,)``."""
        x, y, v, z, u = self._data((data_x, data_y, data_v, data_z, data_u))
        return -_neg_log_posterior_rows_u(self.cfg, self.nets, self.prior_net, z, x, y, v, u,
                                          self._gen if generator is None else generator)

    def _log_prob_with_u(self, data, data_u, nets=None):
        """``log_prob(z, generator) -> (n,)``: the conditional-prior target
        on ``data`` and segments ``data_u`` (differentiable in z)."""
        cfg, prior_net = self.cfg, self.prior_net
        nets = self.nets if nets is None else nets
        x, y, v = self._data(data)
        u = torch.as_tensor(data_u, dtype=torch.float32, device=self.device)

        def log_prob(z, generator):
            return -_neg_log_posterior_rows_u(cfg, nets, prior_net, z, x, y, v, u, generator)

        return log_prob

    def metropolis_hastings_sampler(self, data, initial_q_sd=1.0, q_sd=None, burn_in=5000,
                                    n_keep=3000, target_acceptance_rate=0.25, tolerance=0.05,
                                    adjustment_interval=50, adaptive_sd=None, window_size=100):
        """Adaptive MH over the conditional-prior posterior with fresh
        segments U for the subjects (BNN nets: both sides evaluated afresh
        every step).  Returns ``(samples (n_keep, n, z_dim), data_u (n,
        n_segments))`` as numpy arrays."""
        n = np.shape(data[0])[0]
        data_u = self._sample_u(n)
        if adaptive_sd is None:
            adaptive_sd = q_sd is None or q_sd <= 0
        q0 = initial_q_sd if adaptive_sd else q_sd
        log_prob = self._log_prob_with_u(data, data_u)
        with torch.no_grad():
            init = torch.randn((n, sum(self.cfg.z_dims)), generator=self._gen,
                               device=self.device)
            res = mcmc.adaptive_mh(
                lambda params, z, generator: log_prob(z, generator), init, self._gen,
                burn_in=burn_in, n_keep=n_keep, q_sd=float(q0), adaptive=bool(adaptive_sd),
                target_rate=target_acceptance_rate, tolerance=tolerance,
                adjustment_interval=adjustment_interval, window_size=window_size,
                recompute_current=self.cfg.use_bnn)
        print(f"Final MCMC Acceptance Rate: {float(res.accept_rate):.4f}")
        return res.samples.cpu().numpy(), data_u.cpu().numpy()

    @takes_mesh
    def predict(self, data, alpha=0.01, n_mcmc=3000, burn_in=5000, x_values=None,
                q_sd=1.0, sample_y=True, bs=None, mesh=None, sampler="mh",
                use_best_nets=False, use_swa_nets=False,
                return_diagnostics=False, return_draws=False,
                ess_target=None, ess_rhat=1.01):
        """Causal effects as :meth:`CausalBGM.predict
        <bayesgm_torch.models.causalbgm.CausalBGM.predict>` gives them (the
        plug-in estimator; ``sampler="mh"`` or ``"mala"``, ``ess_target``
        with MH, best or SWA nets, diagnostics, draws), with the conditional
        prior in the chain's target and a fresh U drawn per subject batch.
        The target is the composite: BNN nets evaluate both sides of an MH
        step afresh (two evaluations per step); MALA differentiates it by
        autograd.

        ``mesh`` splits each subject batch's chains and U (drawn for the
        whole batch on every rank) by rank, as :meth:`CausalBGM.predict
        <bayesgm_torch.models.causalbgm.CausalBGM.predict>` does."""
        if sampler not in ("mh", "mala"):
            raise ValueError(f"Unknown sampler: {sampler!r} (expected 'mh' or 'mala').")
        early_stop = None
        if ess_target is not None:
            if sampler != "mh":
                raise ValueError("ess_target requires sampler='mh' (early stopping hooks "
                                 "the chunked MH chain).")
            early_stop = dict(min_ess=float(ess_target), max_rhat=float(ess_rhat))
        if not 0 < alpha < 1:
            raise ValueError("The significance level 'alpha' must be greater than 0 and less than 1.")
        cfg = self.cfg
        if not cfg.binary_treatment and x_values is None:
            raise ValueError("For continuous treatment, 'x_values' must not be None.")
        if x_values is not None:
            x_values = np.atleast_1d(np.asarray(x_values, dtype=float))

        data_x, data_y, data_v = [np.asarray(a, np.float32) for a in data]
        bs = cb._resolve_predict_bs(cfg, bs, len(data_x))
        adaptive = q_sd is None or q_sd <= 0
        q0 = 1.0 if adaptive else float(q_sd)
        nets = self.nets
        if use_best_nets and self.best_nets is not None:
            nets = self.best_nets
        elif use_swa_nets and self.swa_nets is not None:
            nets = self.swa_nets
        print("MCMC Latent Variable Sampling ...")
        collect = cb._effect_collector(cfg, nets, x_values, sample_y)

        def run_batch(bx, by, bv):
            rows = None if mesh is None else mesh.rows(len(bx))
            with torch.no_grad(), rows_mod.split(rows):
                data_u = self._sample_u(len(bx))
                if rows is not None:
                    bx, by, bv = (a[rows.lo:rows.hi] for a in (bx, by, bv))
                    data_u = rows.take(data_u)
                init = cb._randn_rows((len(bx), sum(cfg.z_dims)), self._gen, self.device)
                log_prob = self._log_prob_with_u((bx, by, bv), data_u, nets=nets)
                if sampler == "mala":
                    res = mcmc.adaptive_mala(
                        log_prob, init, self._gen, burn_in=burn_in, n_keep=n_mcmc,
                        step_size=0.1, recompute_current=cfg.use_bnn, collect=collect,
                        mesh=mesh)
                else:
                    res = mcmc.adaptive_mh(
                        lambda params, z, g: log_prob(z, g), init, self._gen, burn_in=burn_in,
                        n_keep=n_mcmc, q_sd=q0, adaptive=adaptive, recompute_current=cfg.use_bnn,
                        collect=lambda params, z, g: collect(z, g), early_stop=early_stop,
                        mesh=mesh)
                rate = float(res.accept_rate)
                samples = res.samples.cpu().numpy()
            print(f"Final MCMC Acceptance Rate: {rate:.4f}")
            return samples, rate

        return self._aggregate_predict(run_batch, (data_x, data_y, data_v), alpha, n_mcmc, bs,
                                       x_values, return_diagnostics, return_draws=return_draws)
