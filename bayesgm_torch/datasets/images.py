"""MNIST-shaped image data (numpy): the seeded ellipse images of
``benchmarks/mnist_inpaint.py`` and the JAX driver's loader of MNIST's
training images (``main.py`` ``_load_mnist_images``), without its keras
download: the port needs no TensorFlow and no network."""

from __future__ import annotations

import os

import numpy as np


def make_ellipse_images(n, seed=0):
    """Binarized random ellipses on a 28x28 grid (seeded), ``(n, 28, 28, 1)``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    imgs = np.zeros((n, 28, 28, 1), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(8, 20, size=2)
        ax_, by_ = rng.uniform(3, 9, size=2)
        th = rng.uniform(0, np.pi)
        c, s = np.cos(th), np.sin(th)
        u = (xx - cx) * c + (yy - cy) * s
        w = -(xx - cx) * s + (yy - cy) * c
        imgs[i, :, :, 0] = ((u / ax_) ** 2 + (w / by_) ** 2 <= 1.0).astype(np.float32)
    return imgs


def load_mnist_images(n_fallback=8192):
    """Binarized MNIST training images ``(n, 28, 28, 1)`` float32 from the
    first ``mnist.npz`` found: ``$BAYESGM_MNIST_NPZ`` (set to a missing file,
    it raises), ``$BAYESGM_DATA/mnist.npz``, ``~/.keras/datasets/mnist.npz``;
    else ``n_fallback`` seeded ellipse images (seed 0)."""
    explicit = os.environ.get("BAYESGM_MNIST_NPZ", "")
    if explicit and not os.path.exists(explicit):
        raise FileNotFoundError(
            f"BAYESGM_MNIST_NPZ is set to '{explicit}' but no such file "
            f"exists — refusing to fall back silently.")
    data_root = os.environ.get("BAYESGM_DATA", "")
    candidates = [explicit,
                  os.path.join(data_root, "mnist.npz") if data_root else "",
                  os.path.expanduser("~/.keras/datasets/mnist.npz")]
    for path in candidates:
        if path and os.path.exists(path):
            with np.load(path) as z:
                x_train = z["x_train"]
            print(f"Loaded MNIST from {path}")
            return (x_train.astype("float32") / 255.0 > 0.5).astype("float32")[..., None]
    print("MNIST unavailable (no local npz, no egress); "
          "using seeded synthetic ellipse images.")
    return make_ellipse_images(n_fallback, seed=0)
