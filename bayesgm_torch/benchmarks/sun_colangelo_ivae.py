"""IdentifiableCausalBGM on the Sun and Colangelo recipes, on the port
(counterpart of ``benchmarks/sun_colangelo_ivae.py``; the same two runs).

- SUN: ``Sim_Sun_sampler(N=20000, v_dim=200)``, z_dims [1,1,1,7], against
  the "Sun" dose-response curve;
- COLANGELO: ``Sim_Colangelo_sampler(N=20000, v_dim=100)``, z_dims
  [5,5,5,5], against the "Lee" curve.

Each: IdentifiableCausalBGM with BNN nets, seed 42, EGM 30000 iterations,
100 epochs (eval every 10), then predict on the 20-point grid over x's
5-95 % quantiles with alpha=0.01, n_mcmc=3000, burn_in=5000, q_sd=1.0.  The
identifiable variant launches no kernel of the port.  The JAX package read
ADRF RMSE 0.0923 (SUN) and 0.0834 (COLANGELO) for these runs.

Beyond the JAX runner (a loop at module level): ``main(argv)``, ``--runs``
(both by default, one after the other; one each runs them as two
processes), ``--seed``, ``--device`` (``cuda`` by default; ``cpu`` only by
name), the size overrides ``--n``, ``--egm``, ``--epochs``, ``--n_mcmc``
and ``--burn_in`` (the recipe's values by default) and ``--state_dir``
(each run's fit checkpointed at every eval epoch under
``DIR/checkpoints/ivae_<RUN>/seed<seed>`` and resumed from there by the
same command).  After JAX's ``RESULT`` line each run prints one JSON line
(``rmse``, ``mape``, ``iv_width_mean``, ``coverage``, ``fit_s``, ``egm_s``,
``predict_s``, the kernel launches and, on CUDA, the card).

Usage:
    python -m bayesgm_torch.benchmarks.sun_colangelo_ivae --runs SUN
    python -m bayesgm_torch.benchmarks.sun_colangelo_ivae --device cpu \\
        --n 200 --egm 10 --epochs 1 --n_mcmc 10 --burn_in 10
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from bayesgm_torch.benchmarks.hi_protocol import _launches, _time_egm
from bayesgm_torch.datasets import Sim_Colangelo_sampler, Sim_Sun_sampler
from bayesgm_torch.models.identifiable import IdentifiableCausalBGM
from bayesgm_torch.utils import get_ADRF
from bayesgm_torch.utils.device import card_info, resolve_device

RUNS = {
    "SUN": (Sim_Sun_sampler, 200, "Sun", [1, 1, 1, 7]),
    "COLANGELO": (Sim_Colangelo_sampler, 100, "Lee", [5, 5, 5, 5]),
}
JAX_RMSE = {"SUN": 0.0923, "COLANGELO": 0.0834}


def run(name, args):
    dev = resolve_device(args.device)
    sampler, v_dim, oracle, z_dims = RUNS[name]
    x, y, v = sampler(N=args.n, v_dim=v_dim).load_all()
    params = dict(binary_treatment=False, dataset=f"ivae_{name}",
                  output_dir=os.path.join(tempfile.gettempdir(), "ivae_sc"), use_bnn=True,
                  save_res=False, save_model=False, v_dim=v_dim, z_dims=list(z_dims))
    kw_init = {}
    if args.state_dir:
        params.update(output_dir=args.state_dir, save_model=True,
                      metrics_path=os.path.join(args.state_dir,
                                                f"metrics_{name}_seed{args.seed}.jsonl"))
        kw_init["timestamp"] = f"seed{args.seed}"
    m = IdentifiableCausalBGM(params, random_seed=args.seed, device=dev, **kw_init)
    timing = _time_egm(m)
    t0 = time.time()
    m.fit((x, y, v), epochs=args.epochs, epochs_per_eval=10, use_egm_init=True,
          egm_n_iter=args.egm, egm_batches_per_eval=args.egm, verbose=0)
    t_fit = time.time() - t0
    launches_fit = _launches(m)
    lo, hi = np.quantile(x, [0.05, 0.95])
    grid = np.linspace(lo, hi, 20)
    true = get_ADRF(x_values=grid, dataset=oracle)
    t0 = time.time()
    adrf, iv = m.predict((x, y, v), alpha=0.01, n_mcmc=args.n_mcmc, burn_in=args.burn_in,
                         x_values=grid, q_sd=1.0)
    t_pred = time.time() - t0
    launches = _launches(m)
    rmse = float(np.sqrt(np.mean((adrf - true) ** 2)))
    mape = float(np.mean(np.abs((adrf - true) / true)))
    print(f"RESULT {name} identifiable: ADRF RMSE {rmse:.4f} MAPE {mape:.4f} "
          f"(fit {t_fit:.0f} s, predict {t_pred:.0f} s)", flush=True)
    out = dict(run=name, seed=args.seed, rmse=rmse, mape=mape,
               iv_width_mean=float(np.mean(iv[:, 1] - iv[:, 0])),
               coverage=float(np.mean((true >= iv[:, 0]) & (true <= iv[:, 1]))),
               fit_s=round(t_fit, 1), **timing, predict_s=round(t_pred, 1),
               jax_rmse=JAX_RMSE[name], launches_fit=launches_fit,
               launches_predict={k: launches[k] - launches_fit[k] for k in launches})
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="+", choices=list(RUNS), default=list(RUNS))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--egm", type=int, default=30000)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--n_mcmc", type=int, default=3000)
    p.add_argument("--burn_in", type=int, default=5000)
    p.add_argument("--state_dir", type=str, default=None,
                   help="checkpoint each run's fit here and resume it from there")
    args = p.parse_args(argv)
    return [run(name, args) for name in args.runs]


if __name__ == "__main__":
    main()
