"""The JAX package's FullMCMC weight HMC and predict on the CPU, started from
a fit saved by ``tools/fullmcmc_stage_split.py``: the reference that the
port's stages B and C are held to (not a test; pytest does not collect it).

It builds ``bayesgm_tpu.models.fullmcmc.FullMCMCCausalBGM`` with
``benchmarks/binary_ate.py``'s params and data (``make_data``, data seed
7), reads the saved nets and latent table through ``load_weights``, runs
``run_mcmc_training`` with the runner's defaults and prints one stage-B
line per net (acceptance over the kept steps, final step size, the
log-likelihood at the fitted weights and over the kept samples, that
trace's ESS and split-R-hat, the min and median ESS over the weight
coordinates), then runs ``predict`` as the runner does (alpha 0.05, q_sd
1.0, n_mcmc 3000, burn_in 5000) twice, the second time on the key
``PRNGKey(1)``, and prints a stage-C line each (dATE, PEHE,
coverage, mean interval width, the latent MH acceptance).  The keys are
the port tool's.

``--samples FILE`` (a ``samples.npz`` of the port tool's ``--save_samples``)
skips the HMC and predicts from those weight samples
(``metropolis_hastings_sampler(g_net_samples=...)`` is what predict calls).

At binary_ate's size on 8 CPU cores (minutes each: the HMC, each predict):
    python tests/_jax_fullmcmc_reference.py --state DIR/fitted.npz --seed 123
    python tests/_jax_fullmcmc_reference.py --state DIR/fitted.npz --seed 123 \\
        --samples DIR2/samples.npz
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesgm_tpu.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402
from bayesgm_tpu.ops import mcmc, nn  # noqa: E402
from benchmarks.binary_ate import make_data  # noqa: E402


class _Recorder:
    """While active, ``mcmc.hmc`` and ``mcmc.adaptive_mh`` keep each run's
    result (and each HMC run's target and start)."""

    def __init__(self):
        self.hmc, self.mh = [], []

    def __enter__(self):
        self._hmc, self._mh = mcmc.hmc, mcmc.adaptive_mh

        def hmc(log_prob_fn, init_state, key, **kw):
            res = self._hmc(log_prob_fn, init_state, key, **kw)
            self.hmc.append((log_prob_fn, init_state, res))
            return res

        def adaptive_mh(*a, **kw):
            res = self._mh(*a, **kw)
            self.mh.append(res)
            return res

        mcmc.hmc, mcmc.adaptive_mh = hmc, adaptive_mh
        return self

    def __exit__(self, *exc):
        mcmc.hmc, mcmc.adaptive_mh = self._hmc, self._mh


def _loglik(log_prob_fn, flat, chunk=16):
    """The HMC target less its N(0, 1) prior at each row of ``flat``."""
    fn = jax.jit(lambda f: log_prob_fn(f, None) - jax.vmap(nn.standard_normal_log_prior)(f))
    out = []
    for s in range(0, flat.shape[0], chunk):
        part = flat[s:s + chunk]
        pad = chunk - part.shape[0]
        if pad:
            part = jnp.concatenate([part, jnp.repeat(part[-1:], pad, axis=0)])
        out.append(np.asarray(fn(part), np.float64)[:chunk - pad])
    return np.concatenate(out)


def net_diagnostics(log_prob_fn, init_state, res):
    samples = res.samples[:, 0, :]
    lik = _loglik(log_prob_fn, samples)
    half = lik.shape[0] // 2
    ess_w = mcmc.effective_sample_size(np.asarray(samples))
    return dict(accept=float(res.accept_rate), step_size=float(res.step_size),
                loglik_fit=float(_loglik(log_prob_fn, init_state)[0]),
                loglik_mean=float(lik.mean()), loglik_first_half=float(lik[:half].mean()),
                loglik_second_half=float(lik[half:].mean()),
                loglik_ess=float(mcmc.effective_sample_size(lik)),
                loglik_rhat=float(mcmc.split_rhat(lik)),
                w_ess_min=float(ess_w.min()), w_ess_median=float(np.median(ess_w)),
                n_weights=int(samples.shape[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--state", required=True, help="fitted.npz of the port tool")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--samples", default=None, help="samples.npz of the port tool")
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--v_dim", type=int, default=100)
    p.add_argument("--data_seed", type=int, default=7)
    p.add_argument("--n_mcmc", type=int, default=3000)
    p.add_argument("--burn_in", type=int, default=5000)
    p.add_argument("--hmc_samples", type=int, default=2000)
    p.add_argument("--hmc_burnin", type=int, default=1000)
    a = p.parse_args(argv)
    x, y, v, tau = make_data(n=a.n, v_dim=a.v_dim, data_seed=a.data_seed)
    data = (x, y, v)
    model = FullMCMCCausalBGM(dict(
        v_dim=v.shape[1], z_dims=[3, 6, 3, 6], binary_treatment=True, dataset="binary_ate",
        output_dir=os.path.dirname(os.path.abspath(a.state)), use_bnn=True, save_res=False,
        save_model=False), random_seed=a.seed)
    model.load_weights(a.state)
    common = dict(seed=a.seed, package="jax", state=a.state, samples=a.samples)
    t0 = time.time()
    with _Recorder() as recorded:
        if a.samples:
            with np.load(a.samples) as f:
                model.g_net_samples, model.h_net_samples, model.f_net_samples = (
                    np.asarray(f[k], np.float32) for k in "ghf")
        else:
            model.run_mcmc_training(data, num_samples=a.hmc_samples, num_burnin=a.hmc_burnin)
            t_hmc = round(time.time() - t0, 1)
            for name, (log_prob_fn, init_state, res) in zip("ghf", recorded.hmc):
                print(json.dumps(dict(stage="B", net=name, hmc_s=t_hmc,
                                      **net_diagnostics(log_prob_fn, init_state, res),
                                      **common)), flush=True)
        for i, pseed in enumerate((None, 1)):
            if pseed is not None:
                model._key = jax.random.PRNGKey(pseed)
            recorded.mh.clear()
            t0 = time.time()
            ite, iv = model.predict(data, alpha=0.05, n_mcmc=a.n_mcmc, burn_in=a.burn_in,
                                    q_sd=1.0)
            ate_true = float(tau.mean())
            print(json.dumps(dict(
                stage="C", predict=i + 1, predict_seed=pseed, n=a.n,
                ate_true=round(ate_true, 4), ate_est=round(float(ite.mean()), 4),
                d_ate=round(abs(float(ite.mean()) - ate_true), 4),
                pehe=round(float(np.sqrt(np.mean((ite - tau) ** 2))), 4),
                ite_coverage=round(float(np.mean((iv[:, 0] <= tau) & (tau <= iv[:, 1]))), 3),
                iv_width_mean=float(np.mean(iv[:, 1] - iv[:, 0])),
                predict_s=round(time.time() - t0, 1),
                latent_accept=float(np.mean([float(r.accept_rate) for r in recorded.mh])),
                latent_q_sd=float(np.mean([float(r.q_sd) for r in recorded.mh])),
                **common)), flush=True)


if __name__ == "__main__":
    main()
