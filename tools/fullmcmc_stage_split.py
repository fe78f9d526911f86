"""FullMCMCCausalBGM's effect error split by stage: the recipe of
``python -m bayesgm_torch.benchmarks.binary_ate --engine fullmcmc`` (or,
with ``--flagship``, of ``hi_protocol --lr_decay cosine --fullmcmc``), built
by the runner's own ``recipe``, read after each of its stages.

Each read-out prints one JSON line with a ``stage`` key:

- ``fit``: ``fit`` as the runner runs it (EGM, then the epochs; K3 on the
  card); the fitted nets and latent table are saved to ``OUT/fitted.npz``
  (``save_weights``: JAX's keys, so the JAX package's ``load_weights``
  reads it).
- ``B``, one line per net g, h, f: ``run_mcmc_training`` as the runner runs
  it, then the HMC's acceptance over the kept steps, its final step size,
  the log-likelihood (the target less the N(0, 1) prior) at the fitted
  weights and over the kept samples (mean, first and second half), the
  ESS and split-R-hat of that trace, and the min and median ESS over the
  weight coordinates.
- ``C``, twice: ``predict`` as the runner runs it, the first time on the
  generator the runner's predict sees (its line is the runner's final line,
  key for key), the second time on a generator reseeded with
  ``PREDICT_SEED``; each adds the latent MH acceptance and its final
  proposal sd.  The gap between the two is predict's own Monte-Carlo
  error.
- ``A``: the fitted point nets alone, through the base class's predict
  (plain MH; K4 on the card) at the runner's ``n_mcmc``, ``burn_in``,
  ``q_sd`` and ``alpha``, on a fresh model restored from ``OUT/fitted.npz``
  with a generator of its own.  It runs last, so the model's own generator
  sees exactly the runner's sequence: fit, weight HMC, first predict.

Saving and the diagnostics draw nothing from the model's generator.
``--from_state DIR`` starts after the fit from ``DIR/fitted.npz`` (fit_s 0,
no EGM, no launch); ``--from_samples`` also takes the weight samples from
``DIR/samples.npz`` (``g``, ``h``, ``f``: ``(num_samples, D)`` flat weights
in JAX's ``ravel_pytree`` order) in place of the weight HMC;
``--save_samples`` writes the weight samples to ``OUT/samples.npz``
(~200 MB for g at binary_ate's widths).  Every other flag goes to the
runner's parser (``--n``, ``--v_dim``, ``--egm``, ``--epochs``, ``--n_mcmc``,
``--burn_in``, ``--state_dir``, ...).

Usage (card: ~31 min alone for binary_ate's fit, then ~3 min):
    python tools/fullmcmc_stage_split.py --seed 123 --out DIR
    python tools/fullmcmc_stage_split.py --flagship --seed 123 --out DIR
    python tools/fullmcmc_stage_split.py --seed 123 --from_state DIR --device cpu \\
        --save_samples --out DIR2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesgm_torch.benchmarks import binary_ate as ba  # noqa: E402
from bayesgm_torch.benchmarks import hi_protocol as hp  # noqa: E402
from bayesgm_torch.models import causalbgm as cb  # noqa: E402
from bayesgm_torch.ops import mcmc  # noqa: E402
from bayesgm_torch.ops.nn import standard_normal_log_prior  # noqa: E402
from bayesgm_torch.utils.device import card_info, resolve_device  # noqa: E402

STATE, SAMPLES = "fitted.npz", "samples.npz"
PREDICT_SEED = 1  # the generator seed of the second predict


class _Recorder:
    """While active, ``mcmc.hmc`` and ``mcmc.adaptive_mh`` keep each run's
    result (and each HMC run's target and start) for the read-outs."""

    def __init__(self):
        self.hmc, self.mh = [], []

    def __enter__(self):
        self._hmc, self._mh = mcmc.hmc, mcmc.adaptive_mh

        def hmc(log_prob_fn, init_state, generator, **kw):
            res = self._hmc(log_prob_fn, init_state, generator, **kw)
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


@torch.no_grad()
def _loglik(log_prob_fn, flat):
    """The HMC target less its N(0, 1) prior at each row of ``flat``
    ``(K, D)``, as float64 numpy (the target draws nothing)."""
    out = [log_prob_fn(flat[i:i + 1], None) - standard_normal_log_prior(flat[i:i + 1])
           for i in range(flat.shape[0])]
    return torch.cat(out).double().cpu().numpy()


def net_diagnostics(log_prob_fn, init_state, res):
    """Stage B of one net from its HMC run."""
    samples = res.samples[:, 0, :]
    lik = _loglik(log_prob_fn, samples)
    half = lik.shape[0] // 2
    ess_w = mcmc.effective_sample_size(samples.cpu().numpy())
    return dict(accept=float(res.accept_rate), step_size=float(res.step_size),
                loglik_fit=float(_loglik(log_prob_fn, init_state)[0]),
                loglik_mean=float(lik.mean()), loglik_first_half=float(lik[:half].mean()),
                loglik_second_half=float(lik[half:].mean()),
                loglik_ess=float(mcmc.effective_sample_size(lik)),
                loglik_rhat=float(mcmc.split_rhat(lik)),
                w_ess_min=float(ess_w.min()), w_ess_median=float(np.median(ess_w)),
                n_weights=int(samples.shape[1]))


def _latent(results):
    """Acceptance and final proposal sd of a stage's MH runs (one per
    subject batch), averaged over the runs."""
    return dict(latent_accept=float(np.mean([float(r.accept_rate) for r in results])),
                latent_q_sd=float(np.mean([float(r.q_sd) for r in results])))


def _emit(line, common):
    print(json.dumps({**line, **common}), flush=True)


def _runner(args, rest):
    """The runner's args and its recipe for this seed."""
    if args.flagship:
        rargs = hp.make_parser().parse_args(
            ["--lr_decay", "cosine", "--fullmcmc", "--seeds", str(args.seed), "--device",
             args.device, *rest])
        return rargs, hp.recipe(args.seed, rargs)
    rargs = ba.make_parser().parse_args(
        ["--engine", "fullmcmc", "--seed", str(args.seed), "--device", args.device, *rest])
    return rargs, ba.recipe(rargs)


def _line(args, rargs, rec, point, iv, t_fit, t_pred, timing, launches, best_epoch=None):
    """The runner's result line for one predict; ``launches`` holds the
    counts of fit, of the weight HMC and of this predict."""
    fit, hmc, pred = launches
    if args.flagship:  # hi_protocol reads launches_fit after the weight HMC
        return dict(seed=args.seed, best_epoch=best_epoch, fit_s=round(t_fit, 1), **timing,
                    **hp.scores(point, iv, rec.true), predict_s=round(t_pred, 1),
                    launches_fit={k: c + hmc[k] for k, c in fit.items()},
                    launches_predict=pred)
    return ba.result_line(rargs, rec, point, iv, t_fit, t_pred, **timing, launches_fit=fit,
                          launches_hmc=hmc, launches_predict=pred)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--flagship", action="store_true",
                   help="hi_protocol --lr_decay cosine --fullmcmc instead of binary_ate")
    p.add_argument("--out", required=True, help="folder for fitted.npz (and samples.npz)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--from_state", default=None, help="folder holding a fitted.npz")
    p.add_argument("--from_samples", action="store_true",
                   help="with --from_state: also its samples.npz, no weight HMC")
    p.add_argument("--save_samples", action="store_true")
    args, rest = p.parse_known_args(argv)
    if args.from_samples and not args.from_state:
        p.error("--from_samples needs --from_state")
    dev = resolve_device(args.device)
    rargs, rec = _runner(args, rest)
    os.makedirs(args.out, exist_ok=True)
    common = dict(seed=args.seed, protocol="flagship" if args.flagship else "binary_ate",
                  from_state=args.from_state, from_samples=args.from_samples)
    if dev.type == "cuda":
        common["card"] = card_info()
    plain_params = {k: v for k, v in rec.params.items() if k != "metrics_path"}
    plain_params["save_model"] = False

    t0 = time.time()
    if args.from_state:
        model = rec.cls(plain_params, random_seed=args.seed, device=dev)
        model.load_weights(os.path.join(args.from_state, STATE))
        t_fit, timing = 0.0, {}
    else:
        model = rec.cls(rec.params, random_seed=args.seed, device=dev, **rec.kw_init)
        timing = hp._time_egm(model)
        model.fit(rec.data, **rec.fit_kw)
        t_fit = time.time() - t0
    launches_fit = hp._launches(model)
    model.save_weights(os.path.join(args.out, STATE))
    _emit(dict(stage="fit", fit_s=round(t_fit, 1), **timing, launches_fit=launches_fit),
          common)

    with _Recorder() as recorded:
        t0 = time.time()
        if args.from_samples:
            with np.load(os.path.join(args.from_state, SAMPLES)) as f:
                for name in "ghf":
                    setattr(model, f"{name}_net_samples", np.asarray(f[name], np.float32))
        else:
            model.run_mcmc_training(rec.data)
        t_hmc = time.time() - t0
        launches_hmc = ba._since(hp._launches(model), launches_fit)
        for name, (log_prob_fn, init_state, res) in zip("ghf", recorded.hmc):
            _emit(dict(stage="B", net=name, hmc_s=round(t_hmc, 1),
                       **net_diagnostics(log_prob_fn, init_state, res)), common)
        recorded.hmc.clear()  # the kept samples on the device
        if args.save_samples:
            np.savez(os.path.join(args.out, SAMPLES), g=model.g_net_samples,
                     h=model.h_net_samples, f=model.f_net_samples)

        for i, pseed in enumerate((None, PREDICT_SEED)):
            if pseed is not None:
                model._gen.manual_seed(pseed)
            before = hp._launches(model)
            t0 = time.time()
            recorded.mh.clear()
            point, iv = model.predict(rec.data, **rec.predict_kw)
            t_pred = time.time() - t0
            line = _line(args, rargs, rec, point, iv, t_fit, t_pred, timing,
                         (launches_fit, launches_hmc, ba._since(hp._launches(model), before)),
                         getattr(model, "best_epoch", None))
            _emit(dict(line, stage="C", predict=i + 1, predict_seed=pseed,
                       **_latent(recorded.mh)), common)

        base = rec.cls(plain_params, random_seed=args.seed, device=dev)
        base.load_weights(os.path.join(args.out, STATE))
        before = hp._launches(base)
        t0 = time.time()
        recorded.mh.clear()
        point, iv = cb.CausalBGM.predict(base, rec.data, **rec.predict_kw, use_best_nets=False)
        t_pred = time.time() - t0
        zero = {k: 0 for k in before}
        line = _line(args, rargs, rec, point, iv, 0.0, t_pred, {},
                     (zero, zero, ba._since(hp._launches(base), before)))
        _emit(dict(line, stage="A", **_latent(recorded.mh)), common)


if __name__ == "__main__":
    main()
