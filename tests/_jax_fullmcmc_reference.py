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

``--flagship`` builds ``benchmarks/hi_protocol.py``'s model and data in
place of binary_ate's (its params at their defaults with ``--lr_decay
cosine``, ``Sim_Hirano_Imbens_sampler(N=20000, v_dim=200, seed=0)``) and
predicts as that runner does (alpha 0.01, the 20-point grid on [0, 3],
``bs=20000``): its stage-C lines hold the ADRF RMSE, MAPE, mean 99 %
interval width and coverage.  ``--save_samples DIR`` writes the weight
samples to ``DIR/samples.npz`` (the port tool's ``--from_samples`` reads
it); ``--predicts 1`` runs only the first predict.  ``--matmul bf16``
rounds both operands of every dense layer's product to bf16 (f32
accumulation), as a TPU's default matmul precision does: it replaces
``bayesgm_tpu.ops.nn.dense_apply`` inside this process, so the HMC targets
and predict's log posterior both see it; the package itself is unchanged.

At binary_ate's size on 8 CPU cores (minutes each: the HMC, each predict):
    python tests/_jax_fullmcmc_reference.py --state DIR/fitted.npz --seed 123
    python tests/_jax_fullmcmc_reference.py --state DIR/fitted.npz --seed 123 \\
        --samples DIR2/samples.npz
    python tests/_jax_fullmcmc_reference.py --flagship --state DIR/fitted.npz --seed 123 \\
        [--matmul bf16] [--save_samples DIR3] [--predicts 1]
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

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402
from bayesgm_tpu.ops import mcmc, nn  # noqa: E402
from bayesgm_tpu.utils import get_ADRF  # noqa: E402
from benchmarks.binary_ate import make_data  # noqa: E402

# benchmarks/hi_protocol.py's parser defaults (with --lr_decay cosine)
FLAGSHIP_PARAMS = dict(
    z_dims=[1, 1, 1, 7], binary_treatment=False, dataset="HI_protocol", use_bnn=False,
    save_res=False, save_model=False, kl_weight=1e-4, lr=2e-4, lr_theta=1e-4, lr_z=1e-4,
    use_z_rec=1.0, lr_decay="cosine", g_units=[64] * 5, e_units=[64] * 5, f_units=[64, 32, 8],
    h_units=[64, 32, 8], deconf_weight=0.0, antithetic_eps=False)
FLAGSHIP_GRID = np.linspace(0, 3, 20)


def bf16_dense_apply(p, x):
    """A dense layer with both operands rounded to bf16 and an f32 result."""
    return jnp.dot(x.astype(jnp.bfloat16), p["w"].astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32) + p["b"]


def build(a):
    """``(model, data, truth)`` for the parsed arguments: the model with the
    saved state loaded; ``truth`` is binary_ate's ITE or the flagship's
    ADRF on its grid."""
    if a.flagship:
        x, y, v = Sim_Hirano_Imbens_sampler(N=a.n, v_dim=a.v_dim, seed=0).load_all()
        params = dict(FLAGSHIP_PARAMS, v_dim=a.v_dim)
        truth = get_ADRF(x_values=FLAGSHIP_GRID, dataset="Imbens")
    else:
        x, y, v, truth = make_data(n=a.n, v_dim=a.v_dim, data_seed=a.data_seed)
        params = dict(v_dim=v.shape[1], z_dims=[3, 6, 3, 6], binary_treatment=True,
                      dataset="binary_ate", use_bnn=True, save_res=False, save_model=False)
    params["output_dir"] = os.path.dirname(os.path.abspath(a.state))
    model = FullMCMCCausalBGM(params, random_seed=a.seed)
    model.load_weights(a.state)
    return model, (x, y, v), truth


def c_line(a, model, data, truth):
    """Predict as the runner does; the scores of a stage-C line."""
    if a.flagship:
        adrf, iv = model.predict(data, alpha=0.01, n_mcmc=a.n_mcmc, burn_in=a.burn_in,
                                 x_values=FLAGSHIP_GRID, q_sd=1.0, bs=20000)
        return dict(n=a.n, rmse=float(np.sqrt(np.mean((adrf - truth) ** 2))),
                    mape=float(np.mean(np.abs((adrf - truth) / truth))),
                    iv_width_mean=float(np.mean(iv[:, 1] - iv[:, 0])),
                    coverage=float(np.mean((truth >= iv[:, 0]) & (truth <= iv[:, 1]))))
    ite, iv = model.predict(data, alpha=0.05, n_mcmc=a.n_mcmc, burn_in=a.burn_in, q_sd=1.0)
    ate_true = float(truth.mean())
    return dict(n=a.n, ate_true=round(ate_true, 4), ate_est=round(float(ite.mean()), 4),
                d_ate=round(abs(float(ite.mean()) - ate_true), 4),
                pehe=round(float(np.sqrt(np.mean((ite - truth) ** 2))), 4),
                ite_coverage=round(float(np.mean((iv[:, 0] <= truth) & (truth <= iv[:, 1]))), 3),
                iv_width_mean=float(np.mean(iv[:, 1] - iv[:, 0])))


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--state", required=True, help="fitted.npz of the port tool")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--flagship", action="store_true",
                   help="hi_protocol --lr_decay cosine --fullmcmc instead of binary_ate")
    p.add_argument("--samples", default=None, help="samples.npz of the port tool")
    p.add_argument("--save_samples", default=None, help="folder for this run's samples.npz")
    p.add_argument("--matmul", choices=["f32", "bf16"], default="f32")
    p.add_argument("--predicts", type=int, choices=[1, 2], default=2)
    p.add_argument("--n", type=int, default=None, help="rows (10000; flagship 20000)")
    p.add_argument("--v_dim", type=int, default=None, help="covariates (100; flagship 200)")
    p.add_argument("--data_seed", type=int, default=7)
    p.add_argument("--n_mcmc", type=int, default=3000)
    p.add_argument("--burn_in", type=int, default=5000)
    p.add_argument("--hmc_samples", type=int, default=2000)
    p.add_argument("--hmc_burnin", type=int, default=1000)
    return p


def parse(argv=None, parser=None):
    """The arguments, the sizes filled in for the recipe."""
    a = (parser or make_parser()).parse_args(argv)
    a.n = a.n or (20000 if a.flagship else 10000)
    a.v_dim = a.v_dim or (200 if a.flagship else 100)
    return a


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
    a = parse(argv)
    dense = nn.dense_apply
    if a.matmul == "bf16":
        nn.dense_apply = bf16_dense_apply
    try:
        run(a)
    finally:
        nn.dense_apply = dense


def run(a):
    model, data, truth = build(a)
    common = dict(seed=a.seed, package="jax", state=a.state, samples=a.samples,
                  protocol="flagship" if a.flagship else "binary_ate", matmul=a.matmul)
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
            recorded.hmc.clear()
            if a.save_samples:
                os.makedirs(a.save_samples, exist_ok=True)
                np.savez(os.path.join(a.save_samples, "samples.npz"), g=model.g_net_samples,
                         h=model.h_net_samples, f=model.f_net_samples)
        for i, pseed in enumerate((None, 1)[:a.predicts]):
            if pseed is not None:
                model._key = jax.random.PRNGKey(pseed)
            recorded.mh.clear()
            t0 = time.time()
            scores = c_line(a, model, data, truth)
            print(json.dumps(dict(
                stage="C", predict=i + 1, predict_seed=pseed, **scores,
                predict_s=round(time.time() - t0, 1),
                latent_accept=float(np.mean([float(r.accept_rate) for r in recorded.mh])),
                latent_q_sd=float(np.mean([float(r.q_sd) for r in recorded.mh])),
                **common)), flush=True)


if __name__ == "__main__":
    main()
