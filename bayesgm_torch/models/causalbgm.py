"""CausalBGM: causal inference with a 4-way partitioned latent generative
model (port of ``bayesgm_tpu/models/causalbgm.py``).

This slice of the port serves ``predict`` for the default flipout-BNN model
(``use_bnn=True``) with the adaptive MH sampler and the plug-in estimator.
Weights come from the port's own init (``random_seed``) or from a JAX
``save_weights`` file (:meth:`CausalBGM.load_weights`).  The MH target is
K1, :func:`~bayesgm_torch.ops._pk_bnn_hosteps.make_fused_causal_logp_bnn_hosteps`:
one unpaired launch for the initial state, then one paired
``[proposed; current]`` launch per step.

The model runs on ``device="cuda"`` by default and raises where CUDA is
absent; ``device="cpu"`` (by name) runs the plain PyTorch versions.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesgm_torch import bridge
from bayesgm_torch.ops import distributions as dist
from bayesgm_torch.ops import mcmc
from bayesgm_torch.ops._pk_bnn_hosteps import make_fused_causal_logp_bnn_hosteps
from bayesgm_torch.ops._pk_util import (
    flatten_flipout_params,
    flipout_step_perturbations,
    split_flipout_flat,
)
from bayesgm_torch.ops.nn import FlipoutMLP, flipout_mlp_apply
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


def _split_z(cfg: CBGMConfig, z):
    d0, d1, d2, _ = cfg.z_dims
    return z[..., :d0], z[..., d0 : d0 + d1], z[..., d0 + d1 : d0 + d1 + d2]


def _apply(cfg: CBGMConfig, net, x, generator):
    """Forward through a flipout MLP (the only kind this slice builds)."""
    return flipout_mlp_apply(net, x, generator)


def _sigma_sq(fixed: Optional[float], raw):
    """Fixed sigma override vs. softplus variance head."""
    if fixed is not None:
        return torch.tensor(float(fixed), dtype=torch.float32, device=raw.device) ** 2
    return dist.softplus_var(raw)


def _neg_log_posterior_rows(cfg, nets, z, x, y, v, generator):
    """Per-sample negative log posterior through the nets' own flipout draws
    (g, then h, then f) — the composite K1 is held against."""
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


def _kernel_seed(generator, device):
    """Two int32 seed words for the kernel's sign generator, drawn on the
    device (no host round trip)."""
    return torch.randint(0, 2**31 - 1, (2,), generator=generator, device=device,
                         dtype=torch.int32)


class CausalBGM:
    """Causal Bayesian Generative Model (predict slice).

    Parameters
    ----------
    params : dict
        Required keys: ``'v_dim'``, ``'z_dims'`` ([z0, z1, z2, z3]),
        ``'binary_treatment'``, ``'dataset'``, ``'output_dir'``.  Optional
        keys as in :data:`DEFAULTS`, plus fixed-variance overrides
        ``'sigma_v'``/``'sigma_x'``/``'sigma_y'`` and ``'antithetic_eps'``.
    timestamp : str or None
        Run timestamp (current local time if None).
    random_seed : int or None
        Seed of the init and of the model's generator (default 42).
    device : str or torch.device
        ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.

    Attributes
    ----------
    kernels : dict
        The K1 wrappers the MH target uses (``"bnn_hosteps"`` for the initial
        evaluation, ``"bnn_hosteps_paired"`` per step); each counts its
        kernel launches in ``launches``.
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
        if not self.cfg.use_bnn:
            raise NotImplementedError("use_bnn=False (plain MLP nets) is not ported yet")
        if p["save_model"]:
            raise NotImplementedError("save_model (checkpointing) is not ported yet")
        self.seed = 42 if random_seed is None else int(random_seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self._build_nets()
        self.data_z = None

        self.timestamp = timestamp
        if self.timestamp is None:
            self.timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.save_dir = "{}/results/{}/{}".format(
            p["output_dir"], p["dataset"], self.timestamp)
        if p["save_res"] and not os.path.exists(self.save_dir):
            os.makedirs(self.save_dir)

    # -- construction -----------------------------------------------------

    def _build_nets(self):
        cfg, p = self.cfg, self.params
        init_gen = torch.Generator().manual_seed(self.seed)
        d0, d1, d2, _ = cfg.z_dims
        nets = {
            "g": FlipoutMLP(sum(cfg.z_dims), cfg.v_dim + 1, p["g_units"], init_gen),
            "h": FlipoutMLP(d0 + d2, 2, p["h_units"], init_gen),
            "f": FlipoutMLP(d0 + d1 + 1, 2, p["f_units"], init_gen),
        }
        self._set_nets(nets)

    def _set_nets(self, nets):
        for net in nets.values():
            net.requires_grad_(False)
        self.nets = {k: nets[k].to(self.device) for k in ("g", "h", "f")}
        dims = [self.nets[k].dims for k in "ghf"]
        self.kernels = {
            "bnn_hosteps": make_fused_causal_logp_bnn_hosteps(self.cfg, *dims),
            "bnn_hosteps_paired": make_fused_causal_logp_bnn_hosteps(self.cfg, *dims,
                                                                     paired=True),
        }

    def get_config(self):
        """Return ``{"params": params}``."""
        return {"params": self.params}

    def load_weights(self, path: str):
        """Restore g/h/f (and the latent table, if present) from a JAX
        ``CausalBGM.save_weights`` ``.npz``; shapes must match this model."""
        bundle = bridge.load_npz(path)
        nets = bundle["nets"]
        for k in ("g", "h", "f"):
            if k not in nets:
                raise ValueError(f"{path}: no flipout net {k!r}")
            if nets[k].dims != self.nets[k].dims:
                raise ValueError(f"{path}: net {k!r} has dims {nets[k].dims}, "
                                 f"this model {self.nets[k].dims}")
        self._set_nets(nets)
        if "data_z" in bundle:
            self.data_z = torch.as_tensor(bundle["data_z"], device=self.device)
        return self

    def initialize_nets(self, print_summary: bool = False):
        """Networks are built eagerly in ``__init__``; optionally print sizes."""
        if print_summary:
            for name in ("g", "f", "h"):
                n_params = sum(t.numel() for t in self.nets[name].parameters())
                print(f"{name}_net: {n_params} parameters")

    # -- MH target ----------------------------------------------------------

    def _make_param_log_prob(self):
        """Params-mode MH target for :func:`bayesgm_torch.ops.mcmc.adaptive_mh`.

        Returns ``(lp, plp, make_params)``:

        - ``lp(params, z, g) -> (n,)``: the log-posterior through K1, with a
          fresh eps draw and fresh sign seed per call;
        - ``plp(params, z_prop, z_cur, g) -> (logp_prop, logp_cur)``: both
          states stacked into one paired K1 launch; eps set 0 feeds the
          proposed half and set 1 the current half, so each state sees its
          own whole-batch eps draw (the reference's two log-posterior calls
          per step);
        - ``make_params(nets, data, paired) -> dict``: flattened kernel
          weights, the raw nets (for the collector), the data and, when
          ``paired``, the data stacked twice.
        """
        cfg = self.cfg
        fused = self.kernels["bnn_hosteps"]
        fused_paired = self.kernels["bnn_hosteps_paired"]
        anti = bool(self.params.get("antithetic_eps", False))

        def make_params(nets, data, paired):
            x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                       for a in data)
            ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(nets[k]))
                             for k in "ghf"))
            p = {"nets": nets, "data": (x, y, v), "w": ws, "sigs": sum(sigs, [])}
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

        return lp, plp, make_params

    # -- inference ----------------------------------------------------------

    def predict(self, data, alpha=0.01, n_mcmc=3000, burn_in=5000, x_values=None,
                q_sd=1.0, sample_y=True, bs=None, sampler="mh", mesh=None,
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

        ``mesh``, ``sampler="mala"``, ``estimator="dr"`` and ``ess_target``
        are not ported yet and raise ``NotImplementedError``.
        """
        if not 0 < alpha < 1:
            raise ValueError("The significance level 'alpha' must be greater than 0 and less than 1.")
        if mesh is not None:
            raise NotImplementedError("predict(mesh=...) is not ported yet")
        if sampler != "mh":
            raise NotImplementedError(f"sampler={sampler!r} is not ported yet (only 'mh')")
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
        adaptive = q_sd is None or q_sd <= 0
        q0 = 1.0 if adaptive else float(q_sd)

        print("MCMC Latent Variable Sampling ...")
        lp, plp, make_params = self._make_param_log_prob()
        collect_p = _effect_collector_p(cfg, x_values, sample_y)

        def run_batch(bx, by, bv):
            with torch.no_grad():
                init = torch.randn((bx.shape[0], sum(cfg.z_dims)), generator=self._gen,
                                   device=self.device)
                params = make_params(self.nets, (bx, by, bv), True)
                res = mcmc.adaptive_mh(
                    lp, init, self._gen, burn_in=burn_in, n_keep=n_mcmc, q_sd=q0,
                    adaptive=adaptive, recompute_current=True, collect=collect_p,
                    paired_log_prob_fn=plp, params=params)
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
