"""Seeded BGM conditional-inference (imputation) benchmark on the port
(counterpart of ``benchmarks/bgm_impute.py``, same arguments and defaults).

Fit BGM on ``simulate_z_hetero`` [Y | X] data (n=20000, x_dim=20,
z_dim=10), then infer p(Y | X) on the last 2000 rows with the outcome
column NaN-masked via HMC, and report imputation RMSE, imputed-vs-true
correlation, central-interval coverage and wall-clocks.  BGM launches no
kernel of the port.  The JAX package's cosine run read RMSE 0.4382,
correlation 0.838, coverage 0.9635 at nominal 0.95 (RESULTS.md).

Beyond the JAX runner: ``--device`` (``cuda`` by default; ``cpu`` only by
name) and, on CUDA, the card's name and power limit on the JSON line.

Usage: python -m bayesgm_torch.benchmarks.bgm_impute [--epochs 100] [--egm 20000]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from bayesgm_torch.datasets import simulate_z_hetero
from bayesgm_torch.models.bgm import BGM
from bayesgm_torch.utils.device import card_info, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--egm", type=int, default=20000)
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--n_test", type=int, default=2000)
    p.add_argument("--n_mcmc", type=int, default=3000)
    p.add_argument("--burn_in", type=int, default=3000)
    p.add_argument("--bs", type=int, default=2000)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr_decay", type=str, default=None)
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    X, Y = simulate_z_hetero(n=args.n, k=3, d=19, seed=args.seed)
    data = np.concatenate([Y[:, None], X], axis=1).astype(np.float32)
    train, test = data[: -args.n_test], data[-args.n_test :].copy()
    truth = test[:, 0].copy()

    params = dict(x_dim=data.shape[1], z_dim=10, dataset="bgm_impute",
                  output_dir=os.path.join(tempfile.gettempdir(), "bgm_impute"),
                  save_res=False, save_model=False)
    if args.lr_decay:
        params["lr_decay"] = args.lr_decay
    model = BGM(params, random_seed=args.seed, device=dev)

    t0 = time.time()
    model.fit(train, epochs=args.epochs, epochs_per_eval=20,
              use_egm_init=True, egm_n_iter=args.egm,
              egm_batches_per_eval=args.egm, verbose=0)
    t_fit = time.time() - t0
    mse_rec = float(model.evaluate(train))

    test[:, 0] = np.nan
    t0 = time.time()
    imputed, intervals = model.predict(
        test, alpha=args.alpha, bs=args.bs, n_mcmc=args.n_mcmc,
        burn_in=args.burn_in, seed=args.seed)
    t_pred = time.time() - t0

    pred = imputed[:, 0]
    rmse = float(np.sqrt(np.mean((pred - truth) ** 2)))
    corr = float(np.corrcoef(pred, truth)[0, 1])
    iv = np.asarray(intervals)  # (n_test, 1, 2) shared missing pattern
    covered = float(np.mean((truth >= iv[:, 0, 0]) & (truth <= iv[:, 0, 1])))

    out = dict(imputation_rmse=round(rmse, 4), corr=round(corr, 4),
               coverage=round(covered, 4), nominal=1 - args.alpha,
               mse_reconstruction=round(mse_rec, 4),
               fit_s=round(t_fit, 1), predict_s=round(t_pred, 1))
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
