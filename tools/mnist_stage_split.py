"""MNISTBGM's reconstruction error split by stage: the mnist_inpaint recipe
(``bayesgm_torch/benchmarks/mnist_inpaint.py``: 8192 ellipse images of the
seed, z_dim 10, EGM then epochs 0..E of batch 32 under ``lr_decay``) up to
``evaluate(train[:2048])``, read after the EGM and after the fit.

Each read-out prints one JSON line: ``mse_reconstruction`` (``evaluate``:
the MSE of ``sigmoid(mu + sqrt(var) eps)`` at ``z = e(x)``), ``mean_var``
(the variance head's mean over the 2048 images) and ``mse_sigmoid_mu``
(the MSE of ``sigmoid(mu)``, no noise).  The read-outs restore the model's
generators, so the fit draws what the runner's fit draws.

``--from_nets FILE`` starts the iterative phase from another fit's
post-EGM nets (a pickle of the JAX package's ``model.nets`` as numpy
trees, read through ``bridge.nets_from_numpy``) in place of the EGM.
``--save_nets PREFIX`` writes the post-EGM and final nets the same way
(``PREFIX.post_egm.pkl``, ``PREFIX.final.pkl``).  ``--read_every K`` also
prints an ``epoch`` line after every K-th epoch of the iterative phase
(epochs 0, K, 2K, ..., the last one the ``final`` line's nets), the
read-outs taken between two epochs of the fit.  ``--conv_dtype bf16``
runs every convolution and dense layer of the conv nets on bf16 operands
with f32 results, as a TPU does at its default precision; the package
itself has no such setting (its convolutions are f32).

Usage (card, ~8 min at full depth):
    python tools/mnist_stage_split.py --seed 42 [--egm 5000 --epochs 60]
    python tools/mnist_stage_split.py --seed 42 --conv_dtype bf16
    python tools/mnist_stage_split.py --seed 42 --from_nets P.post_egm.pkl --read_every 5
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.datasets.images import make_ellipse_images  # noqa: E402
from bayesgm_torch.models.mnist import MNISTBGM  # noqa: E402
from bayesgm_torch.ops import conv, optim  # noqa: E402
from bayesgm_torch.utils.device import card_info, resolve_device  # noqa: E402


class _Bf16Operands:
    """``torch.nn.functional`` for ``ops/conv.py`` with the convolutions'
    operands rounded to bf16 (results back in f32)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv2d(x, w, b=None, **kw):
        return F.conv2d(x.bfloat16(), w.bfloat16(), None, **kw).float() + (
            0.0 if b is None else b[:, None, None])

    @staticmethod
    def conv_transpose2d(x, w, b=None, **kw):
        return F.conv_transpose2d(x.bfloat16(), w.bfloat16(), None, **kw).float() + (
            0.0 if b is None else b[:, None, None])


def _bf16_dense(layer, x):
    return (x.bfloat16() @ layer.w.bfloat16()).float() + layer.b


@torch.no_grad()
def _readout(model, x, tag, t0):
    """The three numbers at ``x`` (the model's generators left as they were)."""
    gen, host = model._gen.get_state(), model._host_gen.get_state()
    mse = float(model.evaluate(x))
    with torch.backends.cudnn.flags(allow_tf32=False):
        xs = model._train_data(x)
        mu, var = conv.mnist_generator_apply(model.nets["g"], conv.mnist_encoder_apply(
            model.nets["e"], xs), generator=model._gen)
        line = dict(stage=tag, mse_reconstruction=mse, mean_var=float(var.mean()),
                    mse_sigmoid_mu=float(((xs - torch.sigmoid(mu)) ** 2).mean()),
                    s=round(time.time() - t0, 1))
    model._gen.set_state(gen)
    model._host_gen.set_state(host)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--egm", type=int, default=5000)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lr_decay", default="cosine")
    p.add_argument("--device", default="cuda")
    p.add_argument("--conv_dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--from_nets", default=None)
    p.add_argument("--save_nets", default=None)
    p.add_argument("--read_every", type=int, default=0,
                   help="also read the model every K epochs of the iterative phase")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.conv_dtype == "bf16":
        conv.F = _Bf16Operands()
        conv.dense_apply = _bf16_dense

    train = make_ellipse_images(8192 + 64, seed=args.seed)[:8192]
    model = MNISTBGM(dict(z_dim=10, dataset="mnist_stage_split", save_res=False,
                          save_model=False, lr_decay=args.lr_decay,
                          output_dir=os.path.join(tempfile.gettempdir(), "mnist_stage_split")),
                     random_seed=args.seed, device=dev)
    common = dict(seed=args.seed, egm=args.egm, epochs=args.epochs, lr_decay=args.lr_decay,
                  conv_dtype=args.conv_dtype, from_nets=args.from_nets)
    if dev.type == "cuda":
        common["card"] = card_info()
    t0 = time.time()
    egm_init = model.egm_init

    def egm_then_read(*a, **kw):
        if args.from_nets:
            with open(args.from_nets, "rb") as f:
                model._copy_nets(bridge.nets_from_numpy(pickle.load(f)), args.from_nets)
        else:
            egm_init(*a, **kw)
        print(json.dumps({**_readout(model, train[:2048], "post_egm", t0), **common}),
              flush=True)
        _save(model, args.save_nets, "post_egm")

    model.egm_init = egm_then_read
    schedule = optim.lr_schedule_scale

    def read_between_epochs(decay, epoch, total):
        # called as epoch ``epoch`` starts: the nets are those after epoch - 1
        if epoch > 0 and (epoch - 1) % args.read_every == 0:
            print(json.dumps({**_readout(model, train[:2048], "epoch", t0), "epoch": epoch - 1,
                              **common}), flush=True)
        return schedule(decay, epoch, total)

    if args.read_every:
        optim.lr_schedule_scale = read_between_epochs
    model.fit(train, epochs=args.epochs, epochs_per_eval=20, use_egm_init=True,
              egm_n_iter=args.egm, egm_batches_per_eval=args.egm, verbose=0)
    optim.lr_schedule_scale = schedule
    final = _readout(model, train[:2048], "final", t0)
    if args.read_every and args.epochs % args.read_every == 0:
        print(json.dumps({**final, "stage": "epoch", "epoch": args.epochs, **common}), flush=True)
    print(json.dumps({**final, **common}), flush=True)
    _save(model, args.save_nets, "final")


def _save(model, prefix, stage):
    if prefix:
        with open(f"{prefix}.{stage}.pkl", "wb") as f:
            pickle.dump(bridge.nets_to_numpy(model.nets), f)


if __name__ == "__main__":
    main()
