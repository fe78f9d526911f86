"""Helpers shared by the port's parity tests: they feed the JAX package and
the port the same random numbers.

- :class:`CounterBits` stands in for the on-core TPU PRNG of the JAX
  kernels (the murmur3 counter stream of tests/test_pallas.py), and
  :func:`replayed_words` hands the port's plain kernels the words the
  stubbed JAX kernel reads;
- :class:`FlipoutDraws` replaces both packages' ``_fused_flipout_draws``
  with one deterministic numpy stream: call ``i`` of either package gets the
  same eps and signs for the same layer shapes.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bayesgm_tpu.ops import nn as jnn
from bayesgm_torch.models import causalbgm as tcb
from bayesgm_torch.ops import nn as tnn


class CounterBits:
    """Deterministic stand-in for the on-core TPU PRNG: draw i is a pure
    function of (i, shape), and the counter resets at prng_seed, so every
    row block of a JAX kernel replays the same words."""

    def __init__(self):
        self.counter = 0

    @staticmethod
    def bits_for(i, shape):
        rows, cols = shape
        idx = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * jnp.uint32(cols)
               + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
        x = idx + jnp.uint32(0x9E3779B9) * jnp.uint32(i + 1)
        x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x85EBCA6B)
        x = (x ^ (x >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
        return x ^ (x >> jnp.uint32(16))

    def seed(self, *words):
        self.counter = 0

    def random_bits(self, shape):
        bits = self.bits_for(self.counter, tuple(shape))
        self.counter += 1
        return bits


def stub_prng(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    stream = CounterBits()
    monkeypatch.setattr(pltpu, "prng_seed", lambda *w: stream.seed(*w))
    monkeypatch.setattr(pltpu, "prng_random_bits", lambda shape: stream.random_bits(shape))
    monkeypatch.setattr(pltpu, "bitcast", lambda x, dt: jax.lax.bitcast_convert_type(x, dt))
    return stream


def replayed_words(dims, rows, block_rows):
    """The words the stubbed JAX kernel reads: per chain one (block_rows,
    max_w) draw, counter 0/1/2 for g/h/f, replayed in every row block."""
    return [torch.as_tensor(np.tile(np.asarray(CounterBits.bits_for(i, (block_rows, max(d)))),
                                    (rows // block_rows, 1)).astype(np.int64))
            for i, d in enumerate(dims)]


def flipout_draw(i, dims, batch):
    """Draw ``i`` of the shared stream: per layer eps (in, out) and +-1 signs
    (batch, in) and (batch, out), as numpy float32."""
    rng = np.random.default_rng(1000 + i)
    eps = [rng.normal(size=(a, b)).astype(np.float32) for a, b in dims]
    sign = lambda *s: (rng.integers(0, 2, size=s) * 2 - 1).astype(np.float32)
    r_in = [sign(batch, a) for a, _ in dims]
    r_out = [sign(batch, b) for _, b in dims]
    return eps, r_in, r_out


class FlipoutDraws:
    """Patch both packages' ``_fused_flipout_draws`` with one numpy stream;
    ``jax_calls`` / ``port_calls`` count the draws each side took."""

    def __init__(self, monkeypatch):
        self.jax_calls = 0
        self.port_calls = 0

        def jax_draws(key, layers, batch):
            dims = [tuple(p["loc"].shape) for p in layers]
            out = flipout_draw(self.jax_calls, dims, int(batch))
            self.jax_calls += 1
            return tuple([jnp.asarray(a) for a in part] for part in out)

        def port_draws(layers, x_shape, generator):
            if len(x_shape) != 2:
                raise ValueError("the shared stream covers 2-D inputs only")
            dims = [tuple(loc.shape) for loc, _, _ in layers]
            out = flipout_draw(self.port_calls, dims, int(x_shape[0]))
            self.port_calls += 1
            dev = layers[0][0].device
            return tuple([torch.as_tensor(a, device=dev) for a in part] for part in out)

        monkeypatch.setattr(jnn, "_fused_flipout_draws", jax_draws)
        monkeypatch.setattr(tnn, "_fused_flipout_draws", port_draws)
        monkeypatch.setattr(tcb, "_fused_flipout_draws", port_draws)

