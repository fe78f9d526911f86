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
(the EGM skipped, the iterative phase from those nets).

A full-depth fit (EGM 5000, epochs 0..60) takes about 3 h on 8 CPU cores:
    python tests/_jax_mnist_reference.py --seed 42 --out DIR/jax42
    python tests/_jax_mnist_reference.py --seed 42 --epochs 10 --split --out DIR/cut42
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

from bayesgm_tpu.models.mnist import MNISTBGM  # noqa: E402
from bayesgm_tpu.ops import conv as cnn  # noqa: E402
from benchmarks.mnist_inpaint import make_ellipse_images  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--egm", type=int, default=5000)
    p.add_argument("--split", action="store_true")
    p.add_argument("--from_nets", default=None,
                   help="pickle of post-EGM nets (numpy trees): skip the EGM, start there")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    train = make_ellipse_images(8192 + 64, seed=a.seed)[:8192]
    model = MNISTBGM(dict(z_dim=10, dataset="mnist_inpaint", save_res=False, save_model=False,
                          lr_decay="cosine", output_dir=os.path.dirname(a.out) or "."),
                     random_seed=a.seed)
    t0 = time.time()

    def readout(stage):
        x = jnp.asarray(train[:2048])
        mu, var = cnn.mnist_generator_apply(
            model.nets["g"], cnn.mnist_encoder_apply(model.nets["e"], x), None)
        return dict(stage=stage, mean_var=float(jnp.mean(var)),
                    mse_sigmoid_mu=float(jnp.mean((x - jax.nn.sigmoid(mu)) ** 2)),
                    s=round(time.time() - t0, 1), seed=a.seed, egm=a.egm, epochs=a.epochs)

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
