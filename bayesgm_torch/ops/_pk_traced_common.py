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
