"""EnsembleCausalBGM: deep-ensemble model averaging over CausalBGM (port of
``bayesgm_tpu/models/ensemble.py``).

K :class:`~bayesgm_torch.models.causalbgm.CausalBGM` members are trained
independently from their own seeds, and their posterior effect draws are
pooled into one mixture.  Each member is a whole CausalBGM: its fit runs K2
(BNN) or K3 (plain) and its predict K1 or K4, with its own checkpoints.
"""

from __future__ import annotations

import numpy as np

from bayesgm_torch.models.causalbgm import CausalBGM


class EnsembleCausalBGM:
    """The equal-weight mixture of ``n_members`` independently trained
    CausalBGM models.

    Parameters
    ----------
    params : dict
        CausalBGM params; the optional ``'n_members'`` (default 3) sets the
        ensemble's size.  Member i gets dataset ``"{dataset}_member{i}"``.
    timestamp : str or None
        Every member's run timestamp.
    random_seed : int or None
        Member i's seed is ``random_seed + 7919 * (i + 1)`` (base 42).
    device : str or torch.device
        Every member's device (``"cuda"`` by default).
    """

    def __init__(self, params, timestamp=None, random_seed=None, device="cuda"):
        params = dict(params)
        self.n_members = int(params.pop("n_members", 3))
        base_seed = 42 if random_seed is None else int(random_seed)
        self.params = params
        self.members = []
        for i in range(self.n_members):
            mp = dict(params)
            mp["dataset"] = f"{params['dataset']}_member{i}"
            self.members.append(CausalBGM(mp, timestamp=timestamp,
                                          random_seed=base_seed + 7919 * (i + 1), device=device))
        self.cfg = self.members[0].cfg

    def get_config(self):
        return {"params": {**self.params, "n_members": self.n_members}}

    def fit(self, data, **kwargs):
        """Fit every member in turn (``kwargs`` go to each member's fit)."""
        for i, m in enumerate(self.members):
            print(f"=== Ensemble member {i + 1}/{self.n_members} ===")
            m.fit(data, **kwargs)

    def evaluate(self, data, data_z=None, nb_intervals=200):
        """The member-mean in-sample effect and the member-mean MSEs,
        ``(causal_pre, mse_x, mse_y, mse_v)`` on the host."""
        outs = [m.evaluate(data, m.data_z if data_z is None else data_z,
                           nb_intervals=nb_intervals) for m in self.members]
        causal = np.mean([o[0].cpu().numpy() for o in outs], axis=0)
        mses = [float(np.mean([float(o[j]) for o in outs])) for j in (1, 2, 3)]
        return (causal, *mses)

    def predict(self, data, alpha=0.01, n_mcmc=3000, burn_in=5000, x_values=None,
                q_sd=1.0, sample_y=True, bs=None, return_diagnostics=False,
                return_draws=False, **kwargs):
        """Causal effects under the uniform mixture of the member posteriors:
        the members' effect draws are pooled along the draw axis (``K *
        n_mcmc`` draws; fewer where ``ess_target`` stops a member early), and
        the point estimate and the ``[alpha/2, 1 - alpha/2]`` interval are the
        pooled draws' mean and quantiles.  ``kwargs`` go to every member's
        predict.  ``return_diagnostics=True`` appends the elementwise minimum
        ESS and maximum split-R̂ over the members and their mean acceptance;
        ``return_draws=True`` appends the pooled draws (the layout of
        :meth:`CausalBGM.predict <bayesgm_torch.models.causalbgm.CausalBGM.predict>`'s)."""
        draws_k, diags = [], []
        for i, m in enumerate(self.members):
            print(f"=== Ensemble member {i + 1}/{self.n_members} predict ===")
            out = m.predict(data, alpha=alpha, n_mcmc=n_mcmc, burn_in=burn_in,
                            x_values=x_values, q_sd=q_sd, sample_y=sample_y, bs=bs,
                            return_diagnostics=return_diagnostics, return_draws=True, **kwargs)
            draws_k.append(np.asarray(out[-1]))
            if return_diagnostics:
                diags.append(out[2])
        draw_axis = 0 if self.cfg.binary_treatment else 1
        pooled = np.concatenate(draws_k, axis=draw_axis)
        point = pooled.mean(axis=draw_axis)
        lower = np.quantile(pooled, alpha / 2, axis=draw_axis)
        upper = np.quantile(pooled, 1 - alpha / 2, axis=draw_axis)
        out = [point, np.stack([lower, upper], axis=1)]
        if return_diagnostics:
            out.append(dict(ess=np.min([d["ess"] for d in diags], axis=0),
                            rhat=np.max([d["rhat"] for d in diags], axis=0),
                            accept_rate=float(np.mean([d["accept_rate"] for d in diags]))))
        if return_draws:
            out.append(pooled)
        return tuple(out)
