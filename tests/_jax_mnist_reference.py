"""The JAX package's MNISTBGM recipe on the CPU in f32: the reference that
``tools/mnist_stage_split.py`` holds the port's fit to (not a test; pytest
does not collect it).

It calls ``bayesgm_tpu.models.mnist.MNISTBGM`` as ``benchmarks/mnist_inpaint.py``
does (8192 ellipse images of the seed, z_dim 10, ``lr_decay`` cosine, EGM
then epochs 0..E of batch 32, ``epochs_per_eval`` 20) up to
``evaluate(train[:2048])``, and prints the port tool's read-outs as JSON
lines: ``mse_reconstruction``, ``mean_var`` (the variance head's mean over
the 2048 images at ``z = e(x)``) and ``mse_sigmoid_mu`` (the MSE of
``sigmoid(mu)``).  ``--split`` also reads them after the EGM (its
``evaluate`` leaves the model's key as it was) and writes the post-EGM nets
as numpy trees (``OUT.post_egm.pkl``; the final nets go to
``OUT.final.pkl``), which the port tool's ``--from_nets`` reads; this
script's ``--from_nets`` reads the port tool's ``--save_nets`` files alike
(the EGM skipped, the iterative phase from those nets).  ``--read_every K``
also prints an ``epoch`` line after every K-th epoch of the iterative
phase (epochs 0, K, 2K, ...): ``mse_sigmoid_mu``, ``mean_var`` and
``mse_reconstruction`` under a fixed key pair, read from the epoch
program's own output, so the fit's keys and trajectory stay as they are.

A full-depth fit (EGM 5000, epochs 0..60) takes about 3 h on 8 CPU cores:
    python tests/_jax_mnist_reference.py --seed 42 --out DIR/jax42
    python tests/_jax_mnist_reference.py --seed 42 --epochs 10 --split --out DIR/cut42
    python tests/_jax_mnist_reference.py --seed 42 --from_nets P.post_egm.pkl \
        --read_every 5 --out DIR/from42
"""

import argparse
import json
import os
import pickle
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesgm_tpu.models import mnist as jmnist  # noqa: E402
from bayesgm_tpu.models.mnist import MNISTBGM  # noqa: E402
from bayesgm_tpu.ops import conv as cnn  # noqa: E402
from benchmarks.mnist_inpaint import make_ellipse_images  # noqa: E402


READ_KEYS = (jax.random.PRNGKey(101), jax.random.PRNGKey(102))  # the epoch lines' noise


class _EpochTap:
    """``jax`` for ``bayesgm_tpu.models.mnist`` whose ``jit`` hands each
    call's output to ``on_epoch``: the fit's per-epoch program is the only
    function that module jits while ``fit`` runs with its EGM skipped."""

    def __init__(self, on_epoch):
        self._on_epoch = on_epoch

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            out = jitted(*args)
            self._on_epoch(out[0])
            return out

        return call


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--egm", type=int, default=5000)
    p.add_argument("--split", action="store_true")
    p.add_argument("--from_nets", default=None,
                   help="pickle of post-EGM nets (numpy trees): skip the EGM, start there")
    p.add_argument("--read_every", type=int, default=0,
                   help="also read the model every K epochs of the iterative phase")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    if a.read_every and not a.from_nets:
        p.error("--read_every needs --from_nets (the EGM's programs are jitted too)")
    train = make_ellipse_images(8192 + 64, seed=a.seed)[:8192]
    model = MNISTBGM(dict(z_dim=10, dataset="mnist_inpaint", save_res=False, save_model=False,
                          lr_decay="cosine", output_dir=os.path.dirname(a.out) or "."),
                     random_seed=a.seed)
    t0 = time.time()

    def readout(stage, g=None):
        x = jnp.asarray(train[:2048])
        mu, var = cnn.mnist_generator_apply(
            model.nets["g"] if g is None else g, cnn.mnist_encoder_apply(model.nets["e"], x),
            None)
        return dict(stage=stage, mean_var=float(jnp.mean(var)),
                    mse_sigmoid_mu=float(jnp.mean((x - jax.nn.sigmoid(mu)) ** 2)),
                    s=round(time.time() - t0, 1), seed=a.seed, egm=a.egm, epochs=a.epochs)

    epochs_done = []

    def on_epoch(carry):
        epoch = len(epochs_done)
        epochs_done.append(epoch)
        if epoch % a.read_every:
            return
        g = carry[0]
        nets = model.nets
        model.nets = {**nets, "g": g}
        mse = float(model.evaluate(train[:2048], keys=READ_KEYS))
        model.nets = nets
        print(json.dumps({**readout("epoch", g), "epoch": epoch, "mse_reconstruction": mse}),
              flush=True)

    if a.read_every:
        jmnist.jax = _EpochTap(on_epoch)

    if a.split or a.from_nets:
        egm_init = model.egm_init

        def egm_then_read(*args, **kw):
            if a.from_nets:
                with open(a.from_nets, "rb") as f:
                    model.nets = jax.tree.map(jnp.asarray, pickle.load(f))
            else:
                egm_init(*args, **kw)
            key = model._key
            mse = float(model.evaluate(train[:2048]))
            model._key = key
            print(json.dumps({**readout("post_egm"), "mse_reconstruction": mse}), flush=True)
            with open(a.out + ".post_egm.pkl", "wb") as f:
                pickle.dump(jax.device_get(model.nets), f)

        model.egm_init = egm_then_read
    model.fit(train, epochs=a.epochs, epochs_per_eval=20, use_egm_init=True, egm_n_iter=a.egm,
              egm_batches_per_eval=a.egm, verbose=0)
    mse = float(model.evaluate(train[:2048]))
    print(json.dumps({**readout("final"), "mse_reconstruction": round(mse, 5)}), flush=True)
    with open(a.out + ".final.pkl", "wb") as f:
        pickle.dump(jax.device_get(model.nets), f)


if __name__ == "__main__":
    main()
