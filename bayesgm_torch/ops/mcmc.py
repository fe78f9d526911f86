"""Adaptive random-walk Metropolis–Hastings and Metropolis-adjusted
Langevin (MALA) on the device, and chain diagnostics (port of
``bayesgm_tpu/ops/mcmc.py``).

All ``n`` subjects are independent chains stepped in lockstep along axis 0.
The chain is a plain Python loop whose state, acceptance window and proposal
sd stay on the device: a step never reads a value back to the host, so the
host only enqueues work.  (The JAX package cuts its chain into 500-step
jitted chunks for the TPU program watchdog; nothing here needs that.)

The adaptation schedule is the reference's: every ``adjustment_interval``
burn-in steps, ``q_sd`` (MALA: the step size) is multiplied by 0.9 or 1.1
when the windowed acceptance rate leaves ``target_rate ± tolerance``.

Randomness comes from one explicit ``torch.Generator``, drawn in a fixed
order each step: the proposal noise, the target evaluation(s), then the
accept uniforms (fresh-noise MALA evaluates the current state first).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class MHResult(NamedTuple):
    samples: Optional[torch.Tensor]  # collected values, leading axis n_keep
    q_sd: torch.Tensor  # final proposal sd (0-d)
    accept_rate: torch.Tensor  # windowed acceptance rate at the end (0-d)


def _record_accept(window, accept, t: int, window_size: int):
    """Store step ``t``'s acceptance fraction in the ring ``window`` (in
    place) and return the windowed rate."""
    window[t % window_size] = accept.to(torch.float32).mean()
    return window.sum() / float(min(t + 1, window_size))


def _adapt(scale, rate, t: int, adaptive: bool, burn_in: int, target_rate: float,
           tolerance: float, adjustment_interval: int):
    """The 0.9 / 1.1 scale adaptation on the burn-in steps where it fires."""
    if adaptive and t < burn_in and t % adjustment_interval == 0 and t > 0:
        scale = torch.where(rate < target_rate - tolerance, scale * 0.9, scale)
        scale = torch.where(rate > target_rate + tolerance, scale * 1.1, scale)
    return scale


def _mh_step(carry, generator, log_prob_fn, q_sd_is_adaptive, burn_in,
             target_rate, tolerance, adjustment_interval, window_size,
             recompute_current, paired_log_prob_fn=None):
    """One MH step.  ``carry = (state, logp, q_sd, window, t)`` with ``t`` a
    host int; ``window`` (the ring of per-step acceptance fractions) is
    updated in place.  Returns ``(carry, windowed_rate)``."""
    state, logp, q_sd, window, t = carry
    proposed = state + q_sd * torch.randn(state.shape, generator=generator,
                                          device=state.device, dtype=state.dtype)
    if recompute_current and paired_log_prob_fn is not None:
        # Both states in one launch, each with its own weight-noise draw.
        logp_prop, logp = paired_log_prob_fn(proposed, state, generator)
    else:
        logp_prop = log_prob_fn(proposed, generator)
        if recompute_current:
            # Stochastic targets re-evaluate the current state with fresh
            # weight noise each step, as the reference does.
            logp = log_prob_fn(state, generator)

    log_ratio = torch.clamp_max(logp_prop - logp, 0.0)
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    accept = u < torch.exp(log_ratio)
    new_state = torch.where(accept[:, None], proposed, state)
    new_logp = torch.where(accept, logp_prop, logp)

    rate = _record_accept(window, accept, t, window_size)
    q_sd = _adapt(q_sd, rate, t, q_sd_is_adaptive, burn_in, target_rate, tolerance,
                  adjustment_interval)
    return (new_state, new_logp, q_sd, window, t + 1), rate


def _window_burn_in(carry, multi_step, generator, adaptive, burn_in, target_rate, tolerance,
                    adjustment_interval, window_size):
    """The burn-in in windows of ``adjustment_interval`` steps, one
    ``multi_step(state, q_sd, g)`` call each.  Returns ``(carry,
    rate)``, ``rate`` the last window's last-step acceptance fraction."""
    state, logp, q_sd, window, t = carry
    k = adjustment_interval
    n_real = torch.tensor(float(state.shape[0]), dtype=torch.float32, device=state.device)
    rate = None
    while t < burn_in:
        rate_now = window.sum() / float(min(max(t, 1), window_size))
        q_sd = _adapt(q_sd, rate_now, t, adaptive, burn_in, target_rate, tolerance, k)
        state, logp, counts = multi_step(state, q_sd, generator)
        rates = counts / n_real
        window[t % window_size:t % window_size + k] = rates
        t += k
        rate = rates[-1]
    return (state, logp, q_sd, window, t), rate


def adaptive_mh(log_prob_fn: Callable, init_state, generator: torch.Generator, *,
                burn_in: int = 5000, n_keep: int = 3000, q_sd: float = 1.0,
                adaptive: bool = True, target_rate: float = 0.25,
                tolerance: float = 0.05, adjustment_interval: int = 50,
                window_size: int = 100, recompute_current: bool = False,
                collect: Optional[Callable] = None,
                paired_log_prob_fn: Optional[Callable] = None,
                multi_step_fn: Optional[Callable] = None,
                params=None, early_stop: Optional[dict] = None) -> MHResult:
    """Vectorized adaptive random-walk Metropolis–Hastings.

    Every callable takes ``params`` (passed through unchanged; the MH
    target's weights and data) first: ``log_prob_fn(params, state, g) ->
    (n,)``, ``paired_log_prob_fn(params, proposed, current, g) ->
    (logp_prop, logp_cur)`` (both states of a ``recompute_current`` step in
    one launch) and ``collect(params, state, g)`` (the per-kept-step
    statistic; the raw state by default).  ``samples`` stacks the collected
    tensors on the device along a leading ``n_keep`` axis (None when
    ``n_keep == 0``).

    ``multi_step_fn(params, state, q_sd, g) -> (state, logp, counts)``
    advances every chain ``adjustment_interval`` steps in one launch (K5,
    the MH window kernel), ``counts`` the rows accepted at each step.  It
    runs the burn-in when ``recompute_current`` holds, ``burn_in > 0`` and
    both ``burn_in`` and ``window_size`` are multiples of
    ``adjustment_interval``; otherwise the burn-in is per step.  q_sd is
    frozen within a window: the 0.9 / 1.1 adaptation fires at the start of
    each window, from the ring's rate over the steps so far (one step later
    than the per-step check), and the window's per-step rates enter the
    ring.  The sampling phase stays per step.

    ``early_stop`` (ESS-adaptive chain length) is not ported yet.
    """
    if early_stop is not None:
        raise NotImplementedError("early_stop (ESS-adaptive chain length) is not ported yet")
    collect_fn = (lambda p, s, g: s) if collect is None else collect
    statics = dict(
        q_sd_is_adaptive=bool(adaptive), burn_in=burn_in, target_rate=target_rate,
        tolerance=tolerance, adjustment_interval=adjustment_interval,
        window_size=window_size, recompute_current=recompute_current)
    step_lp = lambda s, g: log_prob_fn(params, s, g)
    step_plp = None if paired_log_prob_fn is None else (
        lambda a, b, g: paired_log_prob_fn(params, a, b, g))

    dev = init_state.device
    logp0 = log_prob_fn(params, init_state, generator)
    carry = (init_state, logp0, torch.tensor(q_sd, dtype=torch.float32, device=dev),
             torch.zeros((window_size,), dtype=torch.float32, device=dev), 0)
    rate = torch.zeros((), dtype=torch.float32, device=dev)

    use_window = (multi_step_fn is not None and recompute_current and burn_in > 0
                  and adjustment_interval > 0 and burn_in % adjustment_interval == 0
                  and window_size % adjustment_interval == 0)
    if use_window:
        carry, rate = _window_burn_in(
            carry, lambda s, q, g: multi_step_fn(params, s, q, g), generator,
            adaptive=bool(adaptive), burn_in=burn_in, target_rate=target_rate,
            tolerance=tolerance, adjustment_interval=adjustment_interval,
            window_size=window_size)
    else:
        for _ in range(burn_in):
            carry, rate = _mh_step(carry, generator, step_lp,
                                   paired_log_prob_fn=step_plp, **statics)
    samples = []
    for _ in range(n_keep):
        carry, rate = _mh_step(carry, generator, step_lp,
                               paired_log_prob_fn=step_plp, **statics)
        samples.append(collect_fn(params, carry[0], generator))
    stacked = torch.stack(samples) if samples else None
    return MHResult(samples=stacked, q_sd=carry[2], accept_rate=rate)


# ---------------------------------------------------------------------------
# Metropolis-adjusted Langevin (MALA)
# ---------------------------------------------------------------------------


def _mala_proposal(state, grad, eps, generator):
    """``(proposed, drift)``: ``state + eps^2 / 2 * grad + eps * N(0, I)``."""
    drift = 0.5 * eps**2 * grad
    noise = eps * torch.randn(state.shape, generator=generator, device=state.device,
                              dtype=state.dtype)
    return state + drift + noise, drift


def _mala_accept(state, logp, proposed, drift, logp_prop, grad_prop, eps, generator):
    """The accept mask, with the asymmetric proposal correction
    ``log q(x | x') - log q(x' | x)``."""
    fwd = proposed - state - drift
    bwd = state - proposed - 0.5 * eps**2 * grad_prop
    log_q_fwd = -torch.sum(fwd**2, dim=-1) / (2.0 * eps**2)
    log_q_bwd = -torch.sum(bwd**2, dim=-1) / (2.0 * eps**2)
    log_ratio = torch.clamp_max(logp_prop - logp + log_q_bwd - log_q_fwd, 0.0)
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    return torch.log(u) < log_ratio


def _mala_step(carry, generator, value_and_grad_fn, adapt, window_size):
    """One MALA step for a deterministic target: the accepted state's value
    and gradient are cached.  ``carry = (state, logp, grad, eps, window, t)``."""
    state, logp, grad, eps, window, t = carry
    proposed, drift = _mala_proposal(state, grad, eps, generator)
    logp_prop, grad_prop = value_and_grad_fn(proposed, generator)
    accept = _mala_accept(state, logp, proposed, drift, logp_prop, grad_prop, eps, generator)
    state = torch.where(accept[:, None], proposed, state)
    logp = torch.where(accept, logp_prop, logp)
    grad = torch.where(accept[:, None], grad_prop, grad)
    rate = _record_accept(window, accept, t, window_size)
    eps = adapt(eps, rate, t)
    return (state, logp, grad, eps, window, t + 1), rate


def _mala_step_fresh(carry, generator, value_and_grad_fn, adapt, window_size):
    """One MALA step for a STOCHASTIC target (the flipout BNN posterior):
    the current state and the proposal are both evaluated with fresh noise
    every step, nothing is cached (two value-and-gradient calls per step).
    Caching the current value would make the chain stick at lucky noise
    draws.  ``carry = (state, eps, window, t)``."""
    state, eps, window, t = carry
    logp, grad = value_and_grad_fn(state, generator)
    proposed, drift = _mala_proposal(state, grad, eps, generator)
    logp_prop, grad_prop = value_and_grad_fn(proposed, generator)
    accept = _mala_accept(state, logp, proposed, drift, logp_prop, grad_prop, eps, generator)
    state = torch.where(accept[:, None], proposed, state)
    rate = _record_accept(window, accept, t, window_size)
    eps = adapt(eps, rate, t)
    return (state, eps, window, t + 1), rate


def adaptive_mala(log_prob_fn: Callable, init_state, generator: torch.Generator, *,
                  burn_in: int = 5000, n_keep: int = 3000, step_size: float = 0.1,
                  target_rate: float = 0.574, tolerance: float = 0.05,
                  adjustment_interval: int = 50, window_size: int = 100,
                  adaptive: bool = True, recompute_current: bool = False,
                  collect: Optional[Callable] = None) -> MHResult:
    """Metropolis-adjusted Langevin over ``n`` independent chains (rows).

    ``log_prob_fn(state, g) -> (n,)`` must be differentiable in ``state``;
    the target is row-separable, so one backward of the row sum gives every
    row's gradient.  Through the model's kernel target
    (``CausalBGM._make_log_prob(differentiable=True)``) an evaluation is one
    fused value-and-gradient launch.  The step size adapts toward the
    MALA-optimal ~0.574 acceptance during burn-in.

    ``recompute_current=True`` re-evaluates BOTH sides of the accept ratio
    every step (two value-and-gradient calls per step) instead of caching the
    accepted state's value and gradient: required when the target is
    stochastic.  ``collect(state, g)`` is the per-kept-step statistic (the raw
    state by default); ``samples`` stacks it along a leading ``n_keep`` axis
    (None when ``n_keep == 0``), and ``q_sd`` holds the final step size.
    """

    def value_and_grad_fn(s, g):
        with torch.enable_grad():
            ss = s.detach().requires_grad_(True)
            logp = log_prob_fn(ss, g)
            (grad,) = torch.autograd.grad(logp.sum(), ss)
        return logp.detach(), grad

    collect_fn = (lambda s, g: s) if collect is None else collect
    adapt = partial(_adapt, adaptive=bool(adaptive), burn_in=burn_in, target_rate=target_rate,
                    tolerance=tolerance, adjustment_interval=adjustment_interval)
    dev = init_state.device
    eps = torch.tensor(step_size, dtype=torch.float32, device=dev)
    window = torch.zeros((window_size,), dtype=torch.float32, device=dev)
    if recompute_current:
        step, carry = _mala_step_fresh, (init_state, eps, window, 0)
    else:
        logp0, grad0 = value_and_grad_fn(init_state, generator)
        step, carry = _mala_step, (init_state, logp0, grad0, eps, window, 0)

    rate = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(burn_in):
        carry, rate = step(carry, generator, value_and_grad_fn, adapt, window_size)
    samples = []
    for _ in range(n_keep):
        carry, rate = step(carry, generator, value_and_grad_fn, adapt, window_size)
        samples.append(collect_fn(carry[0], generator))
    stacked = torch.stack(samples) if samples else None
    return MHResult(samples=stacked, q_sd=carry[-3], accept_rate=rate)  # carry[-3]: eps


# ---------------------------------------------------------------------------
# Convergence diagnostics: host-side numpy over the collected draws, copied
# from the JAX package (whose module imports jax).
# ---------------------------------------------------------------------------


def _fft_len(n):
    """FFT length used by :func:`_autocovariance` for an n-draw series."""
    return 1 << int(2 * n - 1).bit_length()


def _autocovariance(x):
    """Per-column biased autocovariance of ``x (n, m)`` via FFT."""
    n = x.shape[0]
    xc = x - x.mean(axis=0)
    nfft = _fft_len(n)
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n].real
    return acov / n


def effective_sample_size(draws, axis=0):
    """Effective sample size per series (Geyer initial positive sequence).

    ``draws`` has the MCMC draw axis at ``axis``; every other axis indexes an
    independent series.  Returns an array shaped like ``draws`` without the
    draw axis; constant series report the full draw count, series with
    non-finite draws NaN.
    """
    x = np.moveaxis(np.asarray(draws, np.float64), axis, 0)
    n = x.shape[0]
    shape = x.shape[1:]
    x = x.reshape(n, -1)
    if n < 4:
        return np.where(np.isfinite(x).all(axis=0), float(n), np.nan).reshape(shape)
    out = np.empty(x.shape[1])
    # Bound the FFT workspace near 256 MB per chunk of columns.
    chunk = int(np.clip((1 << 28) // (_fft_len(n) * 16), 128, 8192))
    for c0 in range(0, x.shape[1], chunk):
        xb = x[:, c0 : c0 + chunk]
        acov = _autocovariance(xb)
        var = acov[0]
        ok = var > 0  # False for constant AND for NaN-contaminated series
        rho = acov / np.where(ok, var, 1.0)
        n_pairs = (n - 2) // 2
        gamma = rho[1 : 1 + 2 * n_pairs : 2] + rho[2 : 2 + 2 * n_pairs : 2]
        alive = np.logical_and.accumulate(gamma > 0, axis=0)
        gamma = np.minimum.accumulate(np.where(alive, gamma, np.inf), axis=0)
        gamma = np.where(alive, gamma, 0.0)
        tau = 1.0 + 2.0 * gamma.sum(axis=0)  # includes lag-0 (rho_0 = 1)
        ess = np.where(ok, n / np.maximum(tau, 1.0 / n), float(n))
        ess = np.clip(ess, 1.0, float(n))
        out[c0 : c0 + chunk] = np.where(np.isfinite(xb).all(axis=0), ess, np.nan)
    return out.reshape(shape)


def split_rhat(draws, axis=0):
    """Split-R̂ (Gelman–Rubin on the two halves of each chain).

    Same shape contract as :func:`effective_sample_size`; constant series
    report 1.0, halves stuck at different values inf, non-finite draws NaN.
    """
    x = np.moveaxis(np.asarray(draws, np.float64), axis, 0)
    n = x.shape[0]
    shape = x.shape[1:]
    x = x.reshape(n, -1)
    half = n // 2
    if half < 2:
        return np.where(np.isfinite(x).all(axis=0), 1.0, np.nan).reshape(shape)
    chains = np.stack([x[:half], x[n - half :]])  # (2, half, m)
    W = chains.var(axis=1, ddof=1).mean(axis=0)
    B = half * chains.mean(axis=1).var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    ok = W > 0
    rhat = np.sqrt(var_plus / np.where(ok, W, 1.0))
    stuck_diverged = (~ok) & (B > 0)
    rhat = np.where(ok, rhat, np.where(stuck_diverged, np.inf, 1.0))
    rhat = np.where(np.isfinite(x).all(axis=0), rhat, np.nan)
    return rhat.reshape(shape)


def chain_diagnostics(draws, axis=0, accept_rate=None):
    """Bundle ESS + split-R̂ (+ acceptance) for a block of chain draws."""
    out = {
        "ess": effective_sample_size(draws, axis=axis),
        "rhat": split_rhat(draws, axis=axis),
    }
    if accept_rate is not None:
        out["accept_rate"] = float(accept_rate)
    return out
