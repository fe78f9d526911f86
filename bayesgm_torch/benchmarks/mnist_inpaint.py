"""Seeded MNISTBGM inpainting benchmark on synthetic structured images, on
the port (counterpart of ``benchmarks/mnist_inpaint.py``, same arguments
and defaults).

Seeded binarized random-ellipse images (``datasets.make_ellipse_images``,
bit-equal to the JAX runner's): 8192 to fit and 64 to inpaint.  MNISTBGM
(z_dim 10) fits for 60 epochs after 5000 EGM iterations; the reconstruction
MSE is read on the first 2048 training images; then the lower 14 rows of
the test images are NaN-masked and inpainted by the pixel-level HMC
posterior (2000 burn-in + 2000 kept steps).  Prints the inpainted L1,
pixel accuracy, the all-off baseline and the wall-clocks.  MNISTBGM
launches no kernel of the port; its convolutions run in f32 (the model's
entry points turn cuDNN's TF32 off).  The JAX package's cosine run read
accuracy 0.9366, L1 0.0878, MSE 0.00114 (RESULTS.md).

Beyond the JAX runner: ``--device`` (``cuda`` by default; ``cpu`` only by
name), ``--state_dir`` (the fit checkpointed at every eval epoch under
``DIR/checkpoints/mnist_inpaint/seed<seed>`` and resumed from there by the
same command), ``egm_s`` and, on CUDA, the card's name and power limit on
the JSON line.

Usage: python -m bayesgm_torch.benchmarks.mnist_inpaint [--epochs 60] [--egm 5000]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from bayesgm_torch.benchmarks.hi_protocol import _time_egm
from bayesgm_torch.datasets.images import make_ellipse_images
from bayesgm_torch.models.mnist import MNISTBGM
from bayesgm_torch.utils.device import card_info, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--n_test", type=int, default=64)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--egm", type=int, default=5000)
    p.add_argument("--n_mcmc", type=int, default=2000)
    p.add_argument("--burn_in", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr_decay", type=str, default=None)
    p.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    p.add_argument("--state_dir", type=str, default=None,
                   help="checkpoint the fit here and resume it from there")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    imgs = make_ellipse_images(args.n + args.n_test, seed=args.seed)
    train, test = imgs[: args.n], imgs[args.n :].copy()
    truth = test.copy()

    mparams = dict(z_dim=10, dataset="mnist_inpaint",
                   output_dir=os.path.join(tempfile.gettempdir(), "mnist_inpaint"),
                   save_res=False, save_model=False)
    if args.lr_decay:
        mparams["lr_decay"] = args.lr_decay
    kw_init = {}
    if args.state_dir:
        mparams.update(output_dir=args.state_dir, save_model=True,
                       metrics_path=os.path.join(args.state_dir,
                                                 f"metrics_mnist_seed{args.seed}.jsonl"))
        kw_init["timestamp"] = f"seed{args.seed}"
    model = MNISTBGM(mparams, random_seed=args.seed, device=dev, **kw_init)
    timing = _time_egm(model)
    t0 = time.time()
    model.fit(train, epochs=args.epochs, epochs_per_eval=20,
              use_egm_init=True, egm_n_iter=args.egm,
              egm_batches_per_eval=args.egm, verbose=0)
    t_fit = time.time() - t0
    mse_rec = float(model.evaluate(train[:2048]))

    # Lower-half inpainting: NaN the bottom 14 rows.
    test[:, 14:, :, :] = np.nan
    t0 = time.time()
    imputed, _ = model.predict(test, alpha=0.05, bs=args.n_test,
                               n_mcmc=args.n_mcmc, burn_in=args.burn_in,
                               seed=args.seed)
    t_pred = time.time() - t0

    miss = np.isnan(test)
    l1 = float(np.mean(np.abs(imputed[miss] - truth[miss])))
    acc = float(np.mean((imputed[miss] > 0.5) == (truth[miss] > 0.5)))
    majority = float(np.mean(truth[miss] <= 0.5))  # all-off baseline accuracy

    out = dict(
        inpaint_l1=round(l1, 4), inpaint_accuracy=round(acc, 4),
        majority_baseline=round(max(majority, 1 - majority), 4),
        mse_reconstruction=round(mse_rec, 5),
        fit_s=round(t_fit, 1), predict_s=round(t_pred, 1), **timing)
    if dev.type == "cuda":
        out["card"] = card_info()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
