"""Helpers shared by the kernels' plain PyTorch versions (port of
``bayesgm_tpu/ops/_pk_traced_common.py``): the LeakyReLU, the per-row loss
that every log-posterior kernel folds its three chains into, and the flipout
kernels' per-row Rademacher sign source.

Sign source.  The JAX kernel draws one 32-bit word per (row, col) per
flipout chain and reads sign matrix ``k`` from bit ``k`` (``r_in`` of layer
``i`` is bit ``2i`` on columns ``< in_i``, ``r_out`` is bit ``2i+1`` on
columns ``< out_i``).  The port keeps that bit-slicing and takes the words
from Philox4x32-10 keyed on the two seed words, with the counter
``(global row, col // 4, chain, group)`` and word ``col % 4`` of the output
(chains are 0, 1, 2 for g, h, f; ``group = k // 32`` is non-zero only for
nets with more than 16 layers).  A word then depends on its row and column
alone, not on how rows are tiled, and the CUDA kernel
(``csrc/bnn_hosteps.cu``) computes the same words bit for bit.

The words are carried in int64 tensors masked to 32 bits: torch has no
unsigned 32-bit arithmetic, and the 32x32-bit products are split into
16-bit halves so nothing overflows int64.

In-kernel-eps family (K5, K6, K7; ``csrc/bnn_inkernel.cu``).  Every draw
comes from Philox4x32-10 under the key ``(seed[0], seed[1])``; the top four
bits of counter word 3 name the domain, so no two domains (nor K1's sign
words, domain 0) share a counter.  ``ev = 2 * step + side`` numbers the
evaluations of one launch (side 0 the proposed state, side 1 the current
one; K6 and K7 make one evaluation, ``ev = 0``), ``layer`` is the layer's
index within its chain, ``block = row // block_rows``:

==========  ==================================================  ==========
domain      counter (c0, c1, c2, c3)                            words
==========  ==================================================  ==========
signs  (1)  (row, col // 4, ev, 1<<28 | chain<<8 | group)       col % 4
eps    (2)  (block, pair // 2, ev, 2<<28 | chain<<8 | layer)    see below
proposal(3) (row, pair // 2, step, 3<<28)                       see below
accept (4)  (row, 0, step, 4<<28)                               word 0
==========  ==================================================  ==========

A sign word is read bit-sliced as above.  Normals come in Box-Muller pairs
as the TPU kernel makes them (``_kernel_normal``): a ``(rows, cols)`` draw
has ``ch = ceil(cols / 2)`` pairs per row, pair ``p = r * ch + j`` (eps: ``r``
the layer's input row; proposal: ``p = j`` per chain row) gives ``u1`` and
``u2`` from words 0 and 1 (even ``p``) or 2 and 3 (odd ``p``) of its
counter, and ``r * cos(th)`` lands in column ``j``, ``r * sin(th)`` in
column ``ch + j`` when that is ``< cols``.  A uniform is the word's high 24
bits times 2^-24.  Eps depends on the block, not the row, so all rows of a
block share it and every tile of a block regenerates the same values.
"""

from __future__ import annotations

import torch

from bayesgm_torch.ops.distributions import softplus_var
from bayesgm_torch.ops.nn import LEAKY_SLOPE

_MASK = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _leaky(h):
    return torch.where(h > 0, h, LEAKY_SLOPE * h)


def _sigma_sq(fixed, raw):
    if fixed is not None:
        return torch.tensor(float(fixed), dtype=torch.float32, device=raw.device) ** 2
    return softplus_var(raw)


def neg_log_posterior_rows(cfg, z, x, y, v, chain):
    """``(n,)`` CausalBGM negative log-posterior from the three chains:
    ``chain(ch, inp)`` runs chain ``ch`` (0: g on z, 1: h on (z0, z2), 2: f on
    (z0, z1, x)) and is called in that order.  Gaussian NLLs of v, x and y
    with softplus(raw) + 1e-6 variance heads or fixed sigmas (Bernoulli
    logits for a binary treatment), plus the N(0, I) prior ``sum(z^2) / 2``."""
    d0, d1, d2, _ = cfg.z_dims
    z0, z1, z2 = z[:, :d0], z[:, d0:d0 + d1], z[:, d0 + d1:d0 + d1 + d2]
    g_out = chain(0, z)
    s_v = _sigma_sq(cfg.sigma_v, g_out[:, cfg.v_dim])
    loss = torch.sum((v - g_out[:, :cfg.v_dim]) ** 2, dim=1) / (2.0 * s_v) \
        + cfg.v_dim * torch.log(s_v) / 2.0

    h_out = chain(1, torch.cat([z0, z2], dim=1))
    if cfg.binary_treatment:
        lx = h_out[:, 0]
        loss = loss + torch.clamp_min(lx, 0.0) - lx * x[:, 0] \
            + torch.log1p(torch.exp(-torch.abs(lx)))
    else:
        s_x = _sigma_sq(cfg.sigma_x, h_out[:, 1])
        loss = loss + torch.sum((x - h_out[:, 0:1]) ** 2, dim=1) / (2.0 * s_x) \
            + torch.log(s_x) / 2.0

    f_out = chain(2, torch.cat([z0, z1, x], dim=1))
    s_y = _sigma_sq(cfg.sigma_y, f_out[:, 1])
    loss = loss + torch.sum((y - f_out[:, 0:1]) ** 2, dim=1) / (2.0 * s_y) \
        + torch.log(s_y) / 2.0
    return loss + torch.sum(z * z, dim=1) / 2.0


def _mulhilo(a, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for ``a`` in [0, 2^32)."""
    t_lo = a * (m & 0xFFFF)
    s = a * (m >> 16) + (t_lo >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t_lo & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ``counter`` is four broadcastable tensors, ``key`` two; returns the four
    output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK
            k1 = (k1 + PHILOX_W1) & _MASK
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_sign_words(seed, rows: int, cols: int, chain: int, group: int = 0):
    """``(rows, cols)`` int64 sign words for rows ``0..rows-1``: the word at
    (r, c) is output ``c % 4`` of Philox at counter ``(r, c // 4, chain,
    group)`` under the key ``(seed[0], seed[1])`` (int32 bit patterns)."""
    dev = seed.device
    key = seed.to(torch.int64) & _MASK
    q = (cols + 3) // 4
    r = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    c = torch.arange(q, device=dev, dtype=torch.int64)[None, :]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    words = philox4x32_10((r, c, zero + chain, zero + group), (key[0], key[1]))
    words = [w.expand(rows, q) for w in words]
    return torch.stack(words, dim=-1).reshape(rows, 4 * q)[:, :cols]


TAG_SIGN, TAG_EPS, TAG_PROPOSAL, TAG_ACCEPT = 1, 2, 3, 4
TWO_PI = 2.0 * 3.14159265  # the TPU kernel's constant, rounded to float32 where used


def _kernel_uniform(words):
    """(0, 1) float32 uniforms from the high 24 bits of 32-bit words."""
    return (words >> 8).to(torch.float32) * 2.0**-24


def _kernel_normal(u1_words, u2_words, cols: int):
    """Box-Muller normals from the ``(..., ch)`` pair words: the cos halves,
    then the sin halves, cut to ``cols`` columns (``u1`` clamped at 1e-7)."""
    u1 = torch.clamp_min(_kernel_uniform(u1_words), 1e-7)
    u2 = _kernel_uniform(u2_words)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = torch.tensor(TWO_PI, dtype=torch.float32, device=u2.device) * u2
    return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=-1)[..., :cols]


class PhiloxDraws:
    """The in-kernel-eps family's random words for one launch (the counter
    domains of the module docstring), as int64 tensors of uint32 values.
    The plain versions take their draws from this object; a test may hand
    them another with the same methods."""

    def __init__(self, seed):
        key = seed.to(torch.int64) & _MASK
        self.key = (key[0], key[1])
        self.device = seed.device

    def _words(self, c0, c1, c2, c3):
        zero = torch.zeros((), device=self.device, dtype=torch.int64)
        out = philox4x32_10((c0, c1, zero + c2, zero + c3), self.key)
        shape = torch.broadcast_shapes(c0.shape, c1.shape)
        return [w.expand(shape) for w in out]

    def _pair_words(self, c0, n_pairs: int, c2: int, c3: int):
        """``(u1, u2)`` words of pairs ``0..n_pairs-1`` for each counter c0."""
        q = (n_pairs + 1) // 2
        c1 = torch.arange(q, device=self.device, dtype=torch.int64)[None, :]
        w0, w1, w2, w3 = self._words(c0[:, None], c1, c2, c3)
        m = c0.shape[0]
        u1 = torch.stack([w0, w2], dim=-1).reshape(m, 2 * q)[:, :n_pairs]
        u2 = torch.stack([w1, w3], dim=-1).reshape(m, 2 * q)[:, :n_pairs]
        return u1, u2

    def sign_words(self, rows: int, cols: int, chain: int, ev: int, group: int = 0):
        """``(rows, cols)`` sign words of rows ``0..rows-1`` for evaluation ``ev``."""
        q = (cols + 3) // 4
        r = torch.arange(rows, device=self.device, dtype=torch.int64)[:, None]
        c = torch.arange(q, device=self.device, dtype=torch.int64)[None, :]
        words = self._words(r, c, ev, (TAG_SIGN << 28) | (chain << 8) | group)
        return torch.stack(words, dim=-1).reshape(rows, 4 * q)[:, :cols]

    def eps_words(self, n_blocks: int, rows: int, ch: int, chain: int, layer: int, ev: int):
        """``(u1, u2)`` words, each ``(n_blocks, rows, ch)``, of one layer's
        ``(rows, 2 * ch)`` weight-noise draw in every block."""
        blocks = torch.arange(n_blocks, device=self.device, dtype=torch.int64)
        u1, u2 = self._pair_words(blocks, rows * ch, ev,
                                  (TAG_EPS << 28) | (chain << 8) | layer)
        return u1.reshape(n_blocks, rows, ch), u2.reshape(n_blocks, rows, ch)

    def proposal_words(self, rows: int, ch: int, step: int):
        """``(u1, u2)`` words, each ``(rows, ch)``, of step ``step``'s proposal."""
        r = torch.arange(rows, device=self.device, dtype=torch.int64)
        return self._pair_words(r, ch, step, TAG_PROPOSAL << 28)

    def accept_words(self, rows: int, step: int):
        """``(rows,)`` words of step ``step``'s accept uniforms."""
        r = torch.arange(rows, device=self.device, dtype=torch.int64)
        zero = torch.zeros((), device=self.device, dtype=torch.int64)
        return self._words(r, zero, step, TAG_ACCEPT << 28)[0]


def _sign_source(word_fn):
    """``signs(k, cols) -> (rows, cols)`` float +-1 from bit ``k % 32`` of the
    word group ``k // 32``; ``word_fn(group)`` returns that group's
    ``(rows, max_w)`` words and is called once per group."""
    groups = {}

    def signs(k, cols):
        g = k >> 5
        if g not in groups:
            groups[g] = word_fn(g)
        bit = (groups[g][:, :cols] >> (k & 31)) & 1
        return 1.0 - 2.0 * bit.to(torch.float32)

    return signs
