"""Reproducible binary-treatment benchmark with known ground-truth effects,
on the port (counterpart of ``benchmarks/binary_ate.py``, same arguments
and defaults).

Generator (all ``np.random.RandomState(data_seed)``, bit-equal to the JAX
runner's):
    V ~ N(0, I_100)
    P(X=1 | V) = sigmoid(0.8 v1 - 0.6 v2 + 0.4 v3)          (confounding)
    mu0(V)     = v1 + 0.5 v2 - 0.5 v3 + 0.3 v4 v5           (baseline outcome)
    tau(V)     = 1 + 0.5 sin(v1)                            (heterogeneous ITE)
    Y          = mu0(V) + tau(V) X + N(0, 0.5^2)

Protocol (the ACIC recipe): n=10000, z_dims=[3,6,3,6], BNN, EGM 30000
iterations, 100 epochs of batch 32, predict with n_mcmc=3000, burn_in=5000,
q_sd=1.0, alpha=0.05.  Acceptance bars: dATE <= 0.05, ITE 95 % coverage >=
0.9.  With BNN nets fit runs K2 once per training step (313 per pass) and
predict K1 once unpaired, then once paired per MH step, per 10000-subject
batch.  ``--quick``: n=1000, plain nets, 5 epochs, EGM 500, MH 200 + 300.
``--engine`` picks CausalBGM, IdentifiableCausalBGM, FullMCMCCausalBGM
(fit, then ``run_mcmc_training``) or EnsembleCausalBGM (``--n_members``);
``--identifiable`` is the alias of ``--engine identifiable``.

Beyond the JAX runner: ``--device`` (``cuda`` by default; ``cpu`` only by
name), ``--n``, ``--v_dim``, ``--egm``, ``--epochs``, ``--n_mcmc`` and
``--burn_in`` (the protocol's, or ``--quick``'s, values by default), and
``--state_dir``, which checkpoints the fit at every eval epoch under
``DIR/checkpoints/binary_ate/<engine>_seed<seed>`` and logs its eval
metrics to ``DIR/metrics_<engine>_seed<seed>.jsonl``: the same command run
again resumes the fit where its last checkpoint stopped.  The JSON line
adds ``iv_width_mean`` (the mean ITE interval width), ``egm_s``, the kernel
launches of fit and predict (FullMCMC's weight-space HMC apart,
``launches_hmc``; for an ensemble also each member's,
``launches_members``), and the card's name and power limit on CUDA.
``--member I`` (with ``--engine ensemble`` and ``--state_dir``) fits member
I alone into the state folder and prints its fit line: the members of one
ensemble fit in parallel processes, and the ensemble command run after
them resumes each member from its last checkpoint (no EGM, no epochs) and
predicts.

Usage:
    python -m bayesgm_torch.benchmarks.binary_ate --seed 123
    python -m bayesgm_torch.benchmarks.binary_ate --engine identifiable
    python -m bayesgm_torch.benchmarks.binary_ate --engine ensemble --seed 123 \\
        --state_dir DIR --member 0      # members 1, 2 alike, then without --member
    python -m bayesgm_torch.benchmarks.binary_ate --device cpu --n 200 \\
        --v_dim 10 --egm 10 --epochs 1 --n_mcmc 10 --burn_in 10
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from bayesgm_torch.benchmarks.hi_protocol import _launches, _time_egm
from bayesgm_torch.models.causalbgm import CausalBGM
from bayesgm_torch.models.ensemble import EnsembleCausalBGM
from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM
from bayesgm_torch.models.identifiable import IdentifiableCausalBGM
from bayesgm_torch.utils.device import card_info, resolve_device


def make_data(n=10000, v_dim=100, data_seed=7):
    rng = np.random.RandomState(data_seed)
    v = rng.randn(n, v_dim).astype("float32")
    p = 1.0 / (1.0 + np.exp(-(0.8 * v[:, 0] - 0.6 * v[:, 1] + 0.4 * v[:, 2])))
    x = (rng.rand(n) < p).astype("float32")
    mu0 = v[:, 0] + 0.5 * v[:, 1] - 0.5 * v[:, 2] + 0.3 * v[:, 3] * v[:, 4]
    tau = 1.0 + 0.5 * np.sin(v[:, 0])
    y = (mu0 + tau * x + 0.5 * rng.randn(n)).astype("float32")
    return x.reshape(-1, 1), y.reshape(-1, 1), v, tau


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="tiny smoke run")
    p.add_argument("--seed", type=int, default=123, help="model seed")
    p.add_argument("--data_seed", type=int, default=7)
    p.add_argument("--identifiable", action="store_true")
    p.add_argument("--engine", choices=["base", "identifiable", "fullmcmc", "ensemble"],
                   default=None, help="model variant (overrides --identifiable)")
    p.add_argument("--n_members", type=int, default=3,
                   help="ensemble size when --engine ensemble")
    p.add_argument("--output_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "binary_ate"))
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--v_dim", type=int, default=100)
    p.add_argument("--egm", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n_mcmc", type=int, default=None)
    p.add_argument("--burn_in", type=int, default=None)
    p.add_argument("--state_dir", type=str, default=None,
                   help="checkpoint the fit here and resume it from there")
    p.add_argument("--member", type=int, default=None,
                   help="with --engine ensemble and --state_dir: fit this member alone")
    return p


def recipe(args):
    """The protocol at ``args``: a namespace of ``n``, ``data`` (x, y, v),
    ``tau``, ``engine``, the model class ``cls`` with its ``params`` and
    ``kw_init``, and the keyword arguments of ``fit`` and ``predict``."""
    n = args.n or (1000 if args.quick else 10000)
    x, y, v, tau = make_data(n=n, v_dim=args.v_dim, data_seed=args.data_seed)
    params = dict(
        v_dim=v.shape[1], z_dims=[3, 6, 3, 6], binary_treatment=True,
        dataset="binary_ate", output_dir=args.output_dir,
        use_bnn=not args.quick, save_res=False, save_model=False)
    engine = args.engine or ("identifiable" if args.identifiable else "base")
    cls = {"base": CausalBGM, "identifiable": IdentifiableCausalBGM,
           "fullmcmc": FullMCMCCausalBGM, "ensemble": EnsembleCausalBGM}[engine]
    if engine == "ensemble":
        params["n_members"] = args.n_members
    kw_init = {}
    if args.state_dir:
        tag = f"{engine}_seed{args.seed}"
        params.update(output_dir=args.state_dir, save_model=True,
                      metrics_path=os.path.join(args.state_dir, f"metrics_{tag}.jsonl"))
        kw_init["timestamp"] = tag
    epochs = args.epochs if args.epochs is not None else (5 if args.quick else 100)
    egm = args.egm or (500 if args.quick else 30000)
    fit_kw = dict(epochs=epochs, epochs_per_eval=10, batch_size=32, use_egm_init=True,
                  egm_n_iter=egm, egm_batches_per_eval=egm, verbose=0)
    n_mcmc, burn_in = (200, 300) if args.quick else (3000, 5000)
    predict_kw = dict(alpha=0.05, n_mcmc=args.n_mcmc or n_mcmc,
                      burn_in=args.burn_in or burn_in, q_sd=1.0)
    return SimpleNamespace(n=n, data=(x, y, v), tau=tau, engine=engine, cls=cls,
                           params=params, kw_init=kw_init, fit_kw=fit_kw,
                           predict_kw=predict_kw)


def result_line(args, rec, ite, intervals, t_fit, t_pred, **extra):
    """The JSON line's dict: the JAX runner's keys, then ``iv_width_mean``
    and ``extra`` (EGM wall, launches)."""
    tau = rec.tau
    ate_true = float(tau.mean())
    d_ate = abs(float(ite.mean()) - ate_true)
    pehe = float(np.sqrt(np.mean((ite - tau) ** 2)))
    coverage = float(np.mean((intervals[:, 0] <= tau) & (tau <= intervals[:, 1])))
    return dict(
        n=rec.n, engine=rec.engine, seed=args.seed, data_seed=args.data_seed,
        ate_true=round(ate_true, 4), ate_est=round(float(ite.mean()), 4),
        d_ate=round(d_ate, 4), pehe=round(pehe, 4), ite_coverage=round(coverage, 3),
        fit_s=round(t_fit, 1), predict_s=round(t_pred, 1),
        bars=dict(d_ate=0.05, coverage=0.9),
        iv_width_mean=float(np.mean(intervals[:, 1] - intervals[:, 0])), **extra)


def main(argv=None):
    p = make_parser()
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rec = recipe(args)
    if args.member is not None and (rec.engine != "ensemble" or not args.state_dir
                                    or not 0 <= args.member < args.n_members):
        p.error("--member takes a member index of --engine ensemble with --state_dir")
    model = rec.cls(rec.params, random_seed=args.seed, device=dev, **rec.kw_init)
    if args.member is not None:
        return _fit_member(model.members[args.member], rec.data, rec.fit_kw, args, rec.n, dev)
    timing = _time_egm(model)

    t0 = time.time()
    model.fit(rec.data, **rec.fit_kw)
    t_fit = time.time() - t0
    launches_fit = _launches(model)
    extra = {}
    if rec.engine == "fullmcmc":
        model.run_mcmc_training(rec.data)
        extra["launches_hmc"] = _since(_launches(model), launches_fit)
    before_predict = _launches(model)
    members = getattr(model, "members", [])
    members_fit = [_launches(m) for m in members]

    t0 = time.time()
    ite, intervals = model.predict(rec.data, **rec.predict_kw)
    t_pred = time.time() - t0

    out = result_line(args, rec, ite, intervals, t_fit, t_pred, **timing,
                      launches_fit=launches_fit, **extra,
                      launches_predict=_since(_launches(model), before_predict))
    if rec.engine == "ensemble":
        out["launches_members"] = [dict(fit=f, predict=_since(_launches(m), f))
                                   for m, f in zip(members, members_fit)]
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


def _since(now, before):
    """Launches per wrapper name since the counts ``before``."""
    return {k: c - before.get(k, 0) for k, c in now.items()}


def _fit_member(member, data, fit_kw, args, n, dev):
    """Fit one ensemble member (checkpointed under the state folder) and
    print its line: fit wall, EGM wall and kernel launches."""
    timing = _time_egm(member)
    t0 = time.time()
    member.fit(data, **fit_kw)
    out = dict(n=n, engine="ensemble", seed=args.seed, member=args.member,
               data_seed=args.data_seed, fit_s=round(time.time() - t0, 1), **timing,
               launches_fit=_launches(member))
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
