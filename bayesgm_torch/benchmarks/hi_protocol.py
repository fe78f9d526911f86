"""Seeded Sim_Hirano_Imbens flagship accuracy protocol on the port
(counterpart of ``benchmarks/hi_protocol.py``, same arguments and defaults).

Protocol (reference tutorial and ``bayesgm/models/causalbgm/base.py``):
n=20000, v_dim=200, z_dims=[1,1,1,7], BNN, EGM 30000 iterations, 100
epochs of batch 32, predict with n_mcmc=3000, burn_in=5000, q_sd=1.0 and
alpha=0.01 on the 20-point grid over [0, 3].  With BNN nets fit's latent
update runs K2 once per training step (625 per pass) and predict runs K1
paired once per MH step (1 + burn_in + n_mcmc).

The JAX package's five seeds of the shipped recipe (``--lr_decay cosine``,
seeds 123 456 789 1011 1213, data seed 0) read ADRF RMSE 0.0185-0.0288,
median 0.0200; the reference implementation's five 0.0289 (RESULTS.md).
The summary line carries both.

Beyond the JAX runner: ``--device`` (``cuda`` by default; ``cpu`` only by
name), ``--n``, ``--v_dim``, ``--n_mcmc`` and ``--burn_in`` (the protocol's
values by default; the CPU tests shrink them), and ``--state_dir``, which
checkpoints each seed's full training state at every eval epoch under
``DIR/checkpoints/HI_protocol/seed<seed>`` and logs its eval metrics to
``DIR/metrics_seed<seed>.jsonl``: the same command run again resumes the
seed's fit exactly where its last checkpoint stopped.  Each seed line adds
``egm_s`` (the EGM warm start's wall), the kernel launches of fit and
predict, and the card's name and power limit on CUDA.

Usage:
    python -m bayesgm_torch.benchmarks.hi_protocol --lr_decay cosine \\
        --seeds 123 456 789 1011 1213
    python -m bayesgm_torch.benchmarks.hi_protocol --device cpu --n 200 \\
        --v_dim 10 --z_dims 1 1 1 2 --egm 10 --epochs 1 --n_mcmc 10 \\
        --burn_in 10 --seeds 1 2

Several seeds run concurrently as several processes, one ``--seeds`` value
each.  Prints one JSON line per seed as it ends, then a ``SUMMARY`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from bayesgm_torch.datasets import Sim_Hirano_Imbens_sampler
from bayesgm_torch.models.causalbgm import CausalBGM
from bayesgm_torch.models.ensemble import EnsembleCausalBGM
from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM
from bayesgm_torch.models.identifiable import IdentifiableCausalBGM
from bayesgm_torch.utils import get_ADRF
from bayesgm_torch.utils.device import card_info, resolve_device

JAX_BAND = [0.0185, 0.0288]  # the JAX package's five seeds, lowest and highest
JAX_MEDIAN = 0.0200
REFERENCE_RMSE = 0.0188  # the reference's published single run
REFERENCE_MEDIAN = 0.0289  # the reference's five seeds in the same protocol


def _launches(model):
    """Kernel launches so far per wrapper name, summed over ensemble members."""
    counts = {}
    for m in getattr(model, "members", [model]):
        for name, k in getattr(m, "kernels", {}).items():
            counts[name] = counts.get(name, 0) + k.launches
    return counts


def _time_egm(model):
    """A dict that gets ``egm_s``, the wall of ``model``'s EGM warm start,
    once the warm start has run (a resumed fit skips it)."""
    timing = {}
    egm_init = getattr(model, "egm_init", None)
    if egm_init is not None:
        def timed_egm_init(*a, **kw):
            t = time.time()
            egm_init(*a, **kw)
            timing["egm_s"] = round(time.time() - t, 3)

        model.egm_init = timed_egm_init
    return timing


def recipe(seed, args):
    """One seed of the protocol at ``args``: a namespace of ``data`` (x, y,
    v), the model class ``cls`` with its ``params`` and ``kw_init``, the
    keyword arguments of ``fit`` and ``predict``, and the ADRF ``grid`` with
    its ``true`` values."""
    x, y, v = Sim_Hirano_Imbens_sampler(N=args.n, v_dim=args.v_dim,
                                        seed=args.data_seed).load_all()
    params = dict(
        v_dim=args.v_dim, z_dims=list(args.z_dims), binary_treatment=False,
        dataset="HI_protocol", output_dir=args.output_dir,
        use_bnn=not args.no_bnn, save_res=False, save_model=False,
        kl_weight=args.kl_weight, lr=args.lr, lr_theta=args.lr_theta,
        lr_z=args.lr_z, use_z_rec=args.use_z_rec, lr_decay=args.lr_decay,
        g_units=args.g_units, e_units=args.e_units,
        f_units=args.f_units, h_units=args.h_units,
        deconf_weight=args.deconf_weight,
        antithetic_eps=args.antithetic_eps)
    if args.sigma_y is not None:
        params["sigma_y"] = args.sigma_y
    if args.sigma_x is not None:
        params["sigma_x"] = args.sigma_x
    if args.sigma_v is not None:
        params["sigma_v"] = args.sigma_v
    kw_init = {}
    if args.state_dir:
        params.update(output_dir=args.state_dir, save_model=True,
                      metrics_path=os.path.join(args.state_dir, f"metrics_seed{seed}.jsonl"))
        kw_init["timestamp"] = f"seed{seed}"

    if args.ensemble:
        params["n_members"] = args.ensemble
        cls = EnsembleCausalBGM
    elif args.identifiable:
        cls = IdentifiableCausalBGM
    elif args.fullmcmc:
        cls = FullMCMCCausalBGM
    else:
        cls = CausalBGM
    fit_kw = dict(epochs=args.epochs, epochs_per_eval=10, batch_size=32,
                  use_egm_init=not args.no_egm, egm_n_iter=args.egm,
                  egm_batches_per_eval=args.egm, verbose=0)
    if args.egm_bs:
        fit_kw["egm_batch_size"] = args.egm_bs
    grid = np.linspace(0, 3, 20)
    predict_kw = dict(alpha=0.01, n_mcmc=args.n_mcmc, burn_in=args.burn_in, x_values=grid,
                      q_sd=1.0, bs=20000)
    return SimpleNamespace(data=(x, y, v), cls=cls, params=params, kw_init=kw_init,
                           fit_kw=fit_kw, predict_kw=predict_kw, grid=grid,
                           true=get_ADRF(x_values=grid, dataset="Imbens"))


def scores(adrf, iv, true):
    """RMSE, MAPE, mean interval width and coverage of an ADRF against the
    truth."""
    return dict(rmse=float(np.sqrt(np.mean((adrf - true) ** 2))),
                mape=float(np.mean(np.abs((adrf - true) / true))),
                iv_width_mean=float(np.mean(iv[:, 1] - iv[:, 0])),
                coverage=float(np.mean((true >= iv[:, 0]) & (true <= iv[:, 1]))))


def run_seed(seed, args):
    dev = resolve_device(args.device)
    rec = recipe(seed, args)
    model = rec.cls(rec.params, random_seed=seed, device=dev, **rec.kw_init)

    timing = _time_egm(model)
    t0 = time.time()
    model.fit(rec.data, **rec.fit_kw)
    t_fit = time.time() - t0
    if args.fullmcmc:
        # weight-space HMC over the fitted nets; predict() marginalises
        # over these posterior weight draws (fullmcmc.py run_mcmc_training).
        model.run_mcmc_training(rec.data)
    launches_fit = _launches(model)

    out = dict(seed=seed, best_epoch=getattr(model, "best_epoch", None),
               fit_s=round(t_fit, 1), **timing)
    t0 = time.time()
    data, pred_kw, true = rec.data, rec.predict_kw, rec.true
    variant = args.identifiable or args.ensemble or args.fullmcmc
    kw = {} if variant else dict(use_best_nets=False)
    adrf, iv = model.predict(data, **pred_kw, **kw)
    out.update(scores(adrf, iv, true))
    out["predict_s"] = round(time.time() - t0, 1)
    launches = _launches(model)
    out["launches_fit"] = launches_fit
    out["launches_predict"] = {k: launches[k] - launches_fit[k] for k in launches}
    adrf_final = adrf
    if args.also_best and not variant:
        adrf_b, _ = model.predict(data, **pred_kw, use_best_nets=True)
        out["rmse_best_nets"] = float(np.sqrt(np.mean((adrf_b - true) ** 2)))
    if args.also_swa and not variant:
        adrf_s, _ = model.predict(data, **pred_kw, use_swa_nets=True)
        out["rmse_swa_nets"] = float(np.sqrt(np.mean((adrf_s - true) ** 2)))
        # snapshot ensemble: average the final-nets and SWA-nets curves
        adrf_e = 0.5 * (adrf_final + adrf_s)
        out["rmse_ensemble"] = float(np.sqrt(np.mean((adrf_e - true) ** 2)))
    if args.dump_curves:
        os.makedirs(args.dump_curves, exist_ok=True)
        bundle = dict(grid=rec.grid, true=true, adrf=adrf_final)
        if "rmse_swa_nets" in out:
            bundle["adrf_swa"] = adrf_s
        np.savez(f"{args.dump_curves}/curves_seed{seed}.npz", **bundle)
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


def summarize(results):
    """The ``SUMMARY`` line's dict: the median RMSE beside the JAX band."""
    rmses = sorted(r["rmse"] for r in results)
    summary = dict(median_rmse=float(np.median(rmses)), rmses=rmses,
                   reference_rmse=REFERENCE_RMSE, reference_median=REFERENCE_MEDIAN,
                   jax_band=JAX_BAND, jax_median=JAX_MEDIAN)
    for key in ("rmse_best_nets", "rmse_swa_nets", "rmse_ensemble"):
        if all(key in r for r in results):
            summary[f"median_{key}"] = float(np.median([r[key] for r in results]))
    return summary


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[123, 456, 789, 1011, 1213])
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--egm", type=int, default=30000)
    p.add_argument("--egm_bs", type=int, default=0,
                   help="EGM warm-start batch size (0 = the iterative phase's 32)")
    p.add_argument("--no_egm", action="store_true")
    p.add_argument("--no_bnn", action="store_true")
    p.add_argument("--identifiable", action="store_true")
    p.add_argument("--fullmcmc", action="store_true",
                   help="FullMCMCCausalBGM variant (weight-space HMC)")
    p.add_argument("--ensemble", type=int, default=0,
                   help="train a K-member EnsembleCausalBGM instead")
    p.add_argument("--also_best", action="store_true",
                   help="also predict with the best-mse_y nets snapshot")
    p.add_argument("--also_swa", action="store_true",
                   help="also predict with the tail weight-averaged nets")
    p.add_argument("--kl_weight", type=float, default=1e-4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr_theta", type=float, default=1e-4)
    p.add_argument("--lr_z", type=float, default=1e-4)
    p.add_argument("--use_z_rec", type=float, default=1.0)
    p.add_argument("--deconf_weight", type=float, default=0.0,
                   help="training-time deconfounding penalty on the f-update "
                        "(0 = reference-exact objective)")
    p.add_argument("--antithetic_eps", action="store_true",
                   help="paired MH launches use antithetic flipout eps")
    p.add_argument("--z_dims", type=int, nargs="+", default=[1, 1, 1, 7])
    p.add_argument("--lr_decay", type=str, default=None,
                   choices=[None, "cosine", "linear"])
    p.add_argument("--sigma_v", type=float, default=None)
    p.add_argument("--sigma_x", type=float, default=None)
    p.add_argument("--sigma_y", type=float, default=None)
    p.add_argument("--g_units", type=int, nargs="+", default=[64, 64, 64, 64, 64])
    p.add_argument("--e_units", type=int, nargs="+", default=[64, 64, 64, 64, 64])
    p.add_argument("--f_units", type=int, nargs="+", default=[64, 32, 8])
    p.add_argument("--h_units", type=int, nargs="+", default=[64, 32, 8])
    p.add_argument("--output_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "hi_protocol"))
    p.add_argument("--dump_curves", type=str, default=None,
                   help="directory to save per-seed ADRF curves for bias analysis")
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--v_dim", type=int, default=200)
    p.add_argument("--n_mcmc", type=int, default=3000)
    p.add_argument("--burn_in", type=int, default=5000)
    p.add_argument("--state_dir", type=str, default=None,
                   help="checkpoint each seed's fit here and resume it from there")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    results = [run_seed(s, args) for s in args.seeds]
    print("SUMMARY " + json.dumps(summarize(results)), flush=True)


if __name__ == "__main__":
    main()
