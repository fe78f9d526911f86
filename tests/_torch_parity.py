"""Helpers shared by the port's parity tests: they feed the JAX package and
the port the same random numbers.

- :class:`CounterBits` stands in for the on-core TPU PRNG of the JAX
  kernels (the murmur3 counter stream of tests/test_pallas.py), and
  :func:`replayed_words` hands the port's plain kernels the words the
  stubbed JAX kernel reads (:class:`ReplayedDraws` all the draws of the
  in-kernel-eps kernels, :class:`ProbeReplayedDraws` those of each of the
  JAX probe's variants);
- :class:`FlipoutDraws` replaces both packages' ``_fused_flipout_draws``
  with one deterministic numpy stream: call ``i`` of either package gets the
  same eps and signs for the same layer shapes;
- :func:`patch_interp_weights` hands both packages the same WGAN-GP
  interpolation weights;
- :func:`jax_chain_step_size` is the step size after one HMC step as the
  JAX package's jitted chain rounds its nudge.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bayesgm_tpu.ops import mcmc as jmcmc
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


class ReplayedDraws:
    """The draws the stubbed JAX in-kernel-eps kernels (K5, K6, K7) read, in
    the port's ``PhiloxDraws`` interface.

    The stub's counter restarts in every row block, so every block reads the
    same words.  Per block, in order: (K5 only) the proposal's ``u1``, ``u2``
    of shape (block_rows, ceil(z_dim / 2)); then for each evaluation (K5: the
    proposed state, then the current one) and each chain g, h, f the chain's
    sign words (block_rows, max_w), then ``u1``, ``u2`` (in, ceil(out / 2))
    per layer; then (K5 only) the accept uniforms (block_rows, 1).  The JAX
    window's loop body is traced once, so every step reads the same draws."""

    chain_bits = True  # each chain starts with its sign-word draw
    per_layer = 2  # then draws per layer: u1, u2

    def __init__(self, dims, block_rows, mh_window=False):
        self.dims = dims
        self.block_rows = block_rows
        per_chain = [int(self.chain_bits) + self.per_layer * (len(d) - 1) for d in dims]
        self.chain_off = [0, per_chain[0], per_chain[0] + per_chain[1]]
        self.per_eval = sum(per_chain)
        self.base = 2 if mh_window else 0

    def _rows(self, i, rows, cols):
        """Draw ``i`` of shape (block_rows, cols), replayed over ``rows`` rows."""
        bits = np.asarray(CounterBits.bits_for(i, (self.block_rows, cols))).astype(np.int64)
        return torch.as_tensor(np.tile(bits, (-(-rows // self.block_rows), 1))[:rows])

    def _eval_start(self, chain, ev):
        return self.base + (ev % 2) * self.per_eval + self.chain_off[chain]

    def sign_words(self, rows, cols, chain, ev, group=0):
        if group:
            raise ValueError("the replayed words cover at most 16 layers per chain")
        return self._rows(self._eval_start(chain, ev), rows, cols)

    def eps_words(self, n_blocks, rows, ch, chain, layer, ev):
        i = self._eval_start(chain, ev) + int(self.chain_bits) + self.per_layer * layer
        return tuple(torch.as_tensor(np.asarray(CounterBits.bits_for(j, (rows, ch)))
                                     .astype(np.int64)).expand(n_blocks, rows, ch)
                     for j in (i, i + 1))

    def proposal_words(self, rows, ch, step):
        return self._rows(0, rows, ch), self._rows(1, rows, ch)

    def accept_words(self, rows, step):
        return self._rows(self.base + 2 * self.per_eval, rows, 1)[:, 0]


class ProbeReplayedDraws(ReplayedDraws):
    """The draws the stubbed JAX probe (``benchmarks/mxu_probe.py``) reads for
    one variant, per chain in its order: base, bf16 and xorsign read K6's
    (the chain's sign words, then u1, u2 per layer); noeps and epsref the
    sign words only; nosigns u1, u2 per layer; blockdiag per layer u1, u2,
    then r_in's (block_rows, in) and r_out's (block_rows, out) draws, whose
    low bits become bits 2i and 2i + 1 of the port's sign words; nopert and
    noprng none."""

    LAYOUT = {"base": (True, 2), "bf16": (True, 2), "xorsign": (True, 2), "noeps": (True, 0),
              "epsref": (True, 0), "nosigns": (False, 2), "blockdiag": (False, 4),
              "nopert": (False, 0), "noprng": (False, 0)}

    def __init__(self, variant, dims, block_rows):
        self.chain_bits, self.per_layer = self.LAYOUT[variant]
        self.blockdiag = variant == "blockdiag"
        super().__init__(dims, block_rows)

    def sign_words(self, rows, cols, chain, ev, group=0):
        if not self.blockdiag:
            return super().sign_words(rows, cols, chain, ev, group)
        if group:
            raise ValueError("the replayed words cover at most 16 layers per chain")
        start = self._eval_start(chain, ev)
        words = torch.zeros((rows, cols), dtype=torch.int64)
        d = self.dims[chain]
        for i, (n_in, n_out) in enumerate(zip(d[:-1], d[1:])):
            words[:, :n_in] |= (self._rows(start + 4 * i + 2, rows, n_in) & 1) << (2 * i)
            words[:, :n_out] |= (self._rows(start + 4 * i + 3, rows, n_out) & 1) << (2 * i + 1)
        return words


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
    ``jax_calls`` / ``port_calls`` count the draws each side took.

    With ``broadcast_lead=True`` a port input with leading axes ``(..., n,
    in)`` takes one draw shared by every leading index, as a JAX apply under
    ``vmap`` takes the patched draw once for all mapped points."""

    def __init__(self, monkeypatch, broadcast_lead=False):
        self.jax_calls = 0
        self.port_calls = 0

        def jax_draws(key, layers, batch):
            dims = [tuple(p["loc"].shape) for p in layers]
            out = flipout_draw(self.jax_calls, dims, int(batch))
            self.jax_calls += 1
            return tuple([jnp.asarray(a) for a in part] for part in out)

        def port_draws(layers, x_shape, generator):
            if len(x_shape) != 2 and not broadcast_lead:
                raise ValueError("the shared stream covers 2-D inputs only")
            dims = [tuple(loc.shape) for loc, _, _ in layers]
            out = flipout_draw(self.port_calls, dims, int(x_shape[-2]))
            self.port_calls += 1
            dev = layers[0][0].device
            return tuple([torch.as_tensor(a, device=dev) for a in part] for part in out)

        monkeypatch.setattr(jnn, "_fused_flipout_draws", jax_draws)
        monkeypatch.setattr(tnn, "_fused_flipout_draws", port_draws)
        monkeypatch.setattr(tcb, "_fused_flipout_draws", port_draws)



def patch_interp_weights(monkeypatch, weights):
    """Hand both packages the same WGAN-GP interpolation weights, in order."""
    j_it, t_it = iter(weights), iter(weights)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.full(shape, next(j_it), jnp.float32))
    monkeypatch.setattr(tcb, "_interp_weight", lambda generator, device: torch.tensor(next(t_it)))


@functools.lru_cache(maxsize=None)
def _jitted_flat_hmc_step(n_adapt, adaptation_rate):
    def flat(s, key):
        return jnp.zeros(s.shape[:1]) + 0.0 * jnp.sum(s, axis=-1)

    return jax.jit(lambda carry: jmcmc._hmc_step(
        carry, jax.random.PRNGKey(0), log_prob_fn=flat,
        grad_fn=jax.grad(lambda s, k: jnp.sum(flat(s, k))), num_leapfrog=1, target_accept=0.75,
        n_adapt=n_adapt, adaptation_rate=adaptation_rate))


def jax_chain_step_size(step_size, up, t=0, n_adapt=10, adaptation_rate=0.05):
    """The float32 step size after one step of JAX's ``_hmc_step`` as its
    chain runs it (jitted, where XLA turns the down nudge's division by
    ``1 + adaptation_rate`` into a product with the reciprocal; an eager
    call divides exactly), from ``step_size`` with the mean accept
    probability above the 0.75 target (``up``) or below it, at step ``t``."""
    state = jnp.zeros((4, 2), jnp.float32)
    carried = jnp.full((4,), 0.0 if up else 5.0)  # log accept ratio 0 or -5
    (_, _, size, _), _ = _jitted_flat_hmc_step(n_adapt, adaptation_rate)(
        (state, carried, jnp.float32(step_size), jnp.int32(t)))
    return float(size)
