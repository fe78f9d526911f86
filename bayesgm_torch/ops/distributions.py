"""Likelihood terms with the reference conventions (port of
``bayesgm_tpu/ops/distributions.py``).

- isotropic Gaussian with a scalar-per-sample variance and the
  ``d * log(sigma^2) / 2`` normalizer,
- diagonal Gaussian with per-dimension variance,
- Bernoulli over logits == ``sigmoid_cross_entropy_with_logits``,
- softplus variance floor ``softplus(raw) + 1e-6``.
"""

from __future__ import annotations

import torch


def softplus(x):
    """Overflow-safe softplus ``max(x, 0) + log1p(exp(-|x|))`` — the form of
    ``jax.nn.softplus`` (``torch.nn.functional.softplus`` switches to the
    identity above a threshold instead)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softplus_var(raw, eps: float = 1e-6):
    """Variance head transform: softplus(raw) + eps."""
    return softplus(raw) + eps


def gaussian_nll_iso(x, mu, sigma_sq, n_dims: int):
    """Per-sample NLL (up to const): sum_d (x-mu)^2 / (2 s^2) + d log(s^2)/2.

    ``sigma_sq`` is a scalar or per-sample variance shared across the
    ``n_dims`` output dimensions.  Returns shape ``(batch,)``.
    """
    sq = torch.sum((x - mu) ** 2, dim=-1)
    return sq / (2.0 * sigma_sq) + n_dims * torch.log(sigma_sq) / 2.0


def gaussian_nll_diag(x, mu, sigma_sq):
    """Per-sample NLL with per-dimension variance: shape ``(batch,)``."""
    return torch.sum((x - mu) ** 2 / (2.0 * sigma_sq) + 0.5 * torch.log(sigma_sq), dim=-1)


def bernoulli_logits_nll(labels, logits):
    """Elementwise sigmoid cross-entropy: max(l, 0) - l*z + log(1 + exp(-|l|))."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def standard_normal_neg_log_prior(z):
    """Per-sample -log N(z; 0, I) up to const: sum(z^2)/2.  Shape (batch,)."""
    return torch.sum(z**2, dim=-1) / 2.0


def conditional_gaussian_neg_log_prior(z, mu_z, sigma_sq_z):
    """Per-sample -log N(z; mu(u), diag(s^2(u))) for the identifiable variant."""
    return torch.sum((z - mu_z) ** 2 / (2.0 * sigma_sq_z) + 0.5 * torch.log(sigma_sq_z), dim=-1)
