"""Adaptive random-walk Metropolis–Hastings, Metropolis-adjusted Langevin
(MALA) and Hamiltonian Monte Carlo (HMC) on the device, and chain
diagnostics (port of ``bayesgm_tpu/ops/mcmc.py``).

All ``n`` subjects are independent chains stepped in lockstep along axis 0.
The chain is a plain Python loop whose state, acceptance window and proposal
sd stay on the device: a step never reads a value back to the host, so the
host only enqueues work.  (The JAX package cuts its chain into 500-step
jitted chunks for the TPU program watchdog; here the kept steps are cut at
the same :data:`CHUNK` boundaries only where ``early_stop`` judges the
chain.)

With ``mesh`` (a :class:`bayesgm_torch.parallel.Mesh`) each rank steps the
chains of its own rows (``init_state`` holds them): every per-chain draw is
made at the global row count on every rank and sliced to the local rows,
so world ``W`` draws what world 1 draws, and the means over chains (the
acceptance fraction, HMC's accept probability) are all-reduced.  The
target and the collector run inside the same row split
(:mod:`bayesgm_torch.ops.rows`), so their own per-row draws follow the
rule too.

The adaptation schedule is the reference's: every ``adjustment_interval``
burn-in steps, ``q_sd`` (MALA: the step size) is multiplied by 0.9 or 1.1
when the windowed acceptance rate leaves ``target_rate ± tolerance``.
HMC nudges its scalar step size by ``1 ± adaptation_rate`` every step over
the first ``adapt_fraction`` of the burn-in.

Randomness comes from one explicit ``torch.Generator``, drawn in a fixed
order each step: the proposal noise (HMC: the momentum), the target
evaluation(s), then the accept uniforms (fresh-noise MALA evaluates the
current state first).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesgm_torch.ops import rows as rows_mod

CHUNK = 500  # kept steps between the early-stop gate's checks (the JAX chunk)


class MHResult(NamedTuple):
    samples: Optional[torch.Tensor]  # collected values, leading axis n_keep
    q_sd: torch.Tensor  # final proposal sd (0-d)
    accept_rate: torch.Tensor  # windowed acceptance rate at the end (0-d)


def _record_accept(window, accept, t: int, window_size: int):
    """Store step ``t``'s acceptance fraction in the ring ``window`` (in
    place) and return ``rate()``, the windowed rate, computed when called:
    under a mesh the ring holds this rank's accepted chains over all chains
    and ``rate()`` sums it over the ranks (one all-reduce where a rate is
    read: the adaptation steps and the end)."""
    window[t % window_size] = rows_mod.partial_mean(accept.to(torch.float32))
    return lambda: rows_mod.total(window).sum() / float(min(t + 1, window_size))


def _adapt(scale, rate, t: int, adaptive: bool, burn_in: int, target_rate: float,
           tolerance: float, adjustment_interval: int):
    """The 0.9 / 1.1 scale adaptation on the burn-in steps where it fires
    (``rate()`` gives the windowed acceptance rate)."""
    if adaptive and t < burn_in and t % adjustment_interval == 0 and t > 0:
        rate = rate()
        scale = torch.where(rate < target_rate - tolerance, scale * 0.9, scale)
        scale = torch.where(rate > target_rate + tolerance, scale * 1.1, scale)
    return scale


def _mh_step(carry, generator, log_prob_fn, q_sd_is_adaptive, burn_in,
             target_rate, tolerance, adjustment_interval, window_size,
             recompute_current, paired_log_prob_fn=None):
    """One MH step.  ``carry = (state, logp, q_sd, window, t)`` with ``t`` a
    host int; ``window`` (the ring of per-step acceptance fractions) is
    updated in place.  Returns ``(carry, rate)``, ``rate()`` the windowed
    acceptance rate."""
    state, logp, q_sd, window, t = carry
    proposed = state + q_sd * _randn_rows(state, generator)
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
    u = _rand_rows(logp, generator)
    accept = u < torch.exp(log_ratio)
    new_state = torch.where(accept[:, None], proposed, state)
    new_logp = torch.where(accept, logp_prop, logp)

    rate = _record_accept(window, accept, t, window_size)
    q_sd = _adapt(q_sd, rate, t, q_sd_is_adaptive, burn_in, target_rate, tolerance,
                  adjustment_interval)
    return (new_state, new_logp, q_sd, window, t + 1), rate


def _randn_rows(like, generator):
    """N(0, 1) per chain, shaped like ``like`` (rows on axis 0)."""
    return rows_mod.draw(lambda s: torch.randn(s, generator=generator, device=like.device,
                                               dtype=like.dtype), like.shape)


def _rand_rows(like, generator):
    """U(0, 1) per chain, shaped like ``like`` (rows on axis 0)."""
    return rows_mod.draw(lambda s: torch.rand(s, generator=generator, device=like.device),
                         like.shape)


def _row_split(mesh, init_state):
    """The row split of the chains ``init_state`` holds on this rank (None
    without a mesh)."""
    return None if mesh is None else mesh.rows_of(init_state.shape[0])


def _all_agree(flag: bool, mesh) -> bool:
    """``flag`` when it holds on every rank of ``mesh``."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=mesh.device)
    return bool(mesh.all_reduce_(t, torch.distributed.ReduceOp.MIN).item())


def _window_burn_in(carry, multi_step, generator, adaptive, burn_in, target_rate, tolerance,
                    adjustment_interval, window_size):
    """The burn-in in windows of ``adjustment_interval`` steps, one
    ``multi_step(state, q_sd, g)`` call each.  Returns ``(carry,
    rate)``, ``rate()`` the last window's last-step acceptance fraction."""
    state, logp, q_sd, window, t = carry
    k = adjustment_interval
    n_real = torch.tensor(float(state.shape[0]), dtype=torch.float32, device=state.device)
    rate = None
    while t < burn_in:
        rate_now = window.sum() / float(min(max(t, 1), window_size))
        q_sd = _adapt(q_sd, lambda: rate_now, t, adaptive, burn_in, target_rate, tolerance, k)
        state, logp, counts = multi_step(state, q_sd, generator)
        rates = counts / n_real
        window[t % window_size:t % window_size + k] = rates
        t += k
        rate = rates[-1]
    return (state, logp, q_sd, window, t), lambda: rate


def adaptive_mh(log_prob_fn: Callable, init_state, generator: torch.Generator, *,
                burn_in: int = 5000, n_keep: int = 3000, q_sd: float = 1.0,
                adaptive: bool = True, target_rate: float = 0.25,
                tolerance: float = 0.05, adjustment_interval: int = 50,
                window_size: int = 100, recompute_current: bool = False,
                collect: Optional[Callable] = None,
                paired_log_prob_fn: Optional[Callable] = None,
                multi_step_fn: Optional[Callable] = None,
                params=None, early_stop: Optional[dict] = None, mesh=None) -> MHResult:
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

    ``early_stop`` (a dict; None runs all ``n_keep`` kept steps) stops the
    sampling phase once the collected series have mixed, on the JAX
    package's cadence: after kept step ``done``, a multiple of
    :data:`CHUNK` (or ``n_keep``) below ``n_keep``, when ``done >=
    min_keep`` (default ``2 * CHUNK``) and ``done - last_check >=
    check_every`` (default ``CHUNK``), the chain stops if every series has a
    finite ESS >= ``min_ess`` (required) and a finite split-R̂ <=
    ``max_rhat`` (default 1.01).  ``samples`` then has fewer rows.  A
    collected statistic wider than ``gate_cols`` (default 2048) along its
    second axis is judged on a fixed subsample of that many columns
    (:func:`_gate_column_index`, chosen at the first chunk); each chunk's
    gate columns are sliced on the device and copied to the host once.
    ``gate_cols <= 0`` raises ``ValueError`` (the JAX package takes an empty
    subsample and fails at its first check).

    ``mesh``: the rows of ``init_state`` are this rank's chains (see the
    module docstring); the burn-in is per step (``multi_step_fn`` must be
    None, as the JAX package turns the window off under a mesh), and the
    early-stop gate stops the chain only when it says so on every rank
    (the models' collectors return the same statistic on every rank).
    """
    if mesh is not None and multi_step_fn is not None:
        raise ValueError("adaptive_mh: the K-step window (multi_step_fn) does not run under a mesh")
    with rows_mod.split(_row_split(mesh, init_state)):
        return _adaptive_mh(log_prob_fn, init_state, generator, burn_in, n_keep, q_sd,
                            adaptive, target_rate, tolerance, adjustment_interval,
                            window_size, recompute_current, collect, paired_log_prob_fn,
                            multi_step_fn, params, early_stop, mesh)


def _adaptive_mh(log_prob_fn, init_state, generator, burn_in, n_keep, q_sd, adaptive,
                 target_rate, tolerance, adjustment_interval, window_size, recompute_current,
                 collect, paired_log_prob_fn, multi_step_fn, params, early_stop, mesh):
    gate = None if early_stop is None else _EarlyStopGate(**early_stop)
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
    rate = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731

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
    while len(samples) < n_keep:
        start = len(samples)
        for _ in range(min(CHUNK, n_keep - start)):
            carry, rate = _mh_step(carry, generator, step_lp,
                                   paired_log_prob_fn=step_plp, **statics)
            samples.append(collect_fn(params, carry[0], generator))
        if gate is not None and _all_agree(gate.stop(samples[start:], len(samples), n_keep),
                                           mesh):
            break
    stacked = torch.stack(samples) if samples else None
    return MHResult(samples=stacked, q_sd=carry[2], accept_rate=rate())


def _gate_column_index(width: int, gate_cols: int) -> np.ndarray:
    """The sorted column subsample the early-stop gate judges a wide
    statistic on: ``gate_cols`` of ``width`` columns, drawn as the JAX
    package draws them (``RandomState(0).choice``, no replacement)."""
    return np.sort(np.random.RandomState(0).choice(width, gate_cols, replace=False))


class _EarlyStopGate:
    """The ESS / split-R̂ stopping rule of ``adaptive_mh(early_stop=...)``,
    judged on host copies of the gate columns, chunk by chunk."""

    def __init__(self, min_ess, max_rhat=1.01, min_keep=2 * CHUNK, check_every=CHUNK,
                 gate_cols=2048):
        if int(gate_cols) <= 0:
            raise ValueError(f"gate_cols must be positive, got {gate_cols}")
        self.min_ess, self.max_rhat = float(min_ess), float(max_rhat)
        self.min_keep, self.check_every = int(min_keep), max(1, int(check_every))
        self.gate_cols = int(gate_cols)
        self.index = None  # a wide statistic's gate columns, fixed at the first chunk
        self.host = []  # the gate columns of every chunk so far, on the host
        self.last_check = 0

    def stop(self, chunk, done: int, n_keep: int) -> bool:
        """Take the newest chunk of collected steps; True when the chain
        should stop after ``done`` kept steps."""
        chunk = torch.stack(chunk)
        if not self.host and chunk.ndim >= 2 and chunk.shape[1] > self.gate_cols:
            self.index = torch.as_tensor(_gate_column_index(chunk.shape[1], self.gate_cols),
                                         device=chunk.device)
        if self.index is not None:
            chunk = chunk.index_select(1, self.index)
        self.host.append(chunk.cpu().numpy())
        if done >= n_keep or done < self.min_keep or done - self.last_check < self.check_every:
            return False
        self.last_check = done
        arr = np.concatenate(self.host, axis=0)
        ess, rhat = effective_sample_size(arr), split_rhat(arr)
        return bool(np.all(np.isfinite(ess)) and np.min(ess) >= self.min_ess
                    and np.all(np.isfinite(rhat)) and np.max(rhat) <= self.max_rhat)


# ---------------------------------------------------------------------------
# Metropolis-adjusted Langevin (MALA)
# ---------------------------------------------------------------------------


def _mala_proposal(state, grad, eps, generator):
    """``(proposed, drift)``: ``state + eps^2 / 2 * grad + eps * N(0, I)``."""
    drift = 0.5 * eps**2 * grad
    noise = eps * _randn_rows(state, generator)
    return state + drift + noise, drift


def _mala_accept(state, logp, proposed, drift, logp_prop, grad_prop, eps, generator):
    """The accept mask, with the asymmetric proposal correction
    ``log q(x | x') - log q(x' | x)``."""
    fwd = proposed - state - drift
    bwd = state - proposed - 0.5 * eps**2 * grad_prop
    log_q_fwd = -torch.sum(fwd**2, dim=-1) / (2.0 * eps**2)
    log_q_bwd = -torch.sum(bwd**2, dim=-1) / (2.0 * eps**2)
    log_ratio = torch.clamp_max(logp_prop - logp + log_q_bwd - log_q_fwd, 0.0)
    u = _rand_rows(logp, generator)
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
                  collect: Optional[Callable] = None, mesh=None) -> MHResult:
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
    ``mesh``: the rows of ``init_state`` are this rank's chains (see the
    module docstring).
    """
    with rows_mod.split(_row_split(mesh, init_state)):
        return _adaptive_mala(log_prob_fn, init_state, generator, burn_in, n_keep, step_size,
                              target_rate, tolerance, adjustment_interval, window_size,
                              adaptive, recompute_current, collect)


def _adaptive_mala(log_prob_fn, init_state, generator, burn_in, n_keep, step_size, target_rate,
                   tolerance, adjustment_interval, window_size, adaptive, recompute_current,
                   collect):

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

    rate = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
    for _ in range(burn_in):
        carry, rate = step(carry, generator, value_and_grad_fn, adapt, window_size)
    samples = []
    for _ in range(n_keep):
        carry, rate = step(carry, generator, value_and_grad_fn, adapt, window_size)
        samples.append(collect_fn(carry[0], generator))
    stacked = torch.stack(samples) if samples else None
    return MHResult(samples=stacked, q_sd=carry[-3], accept_rate=rate())  # carry[-3]: eps


# ---------------------------------------------------------------------------
# Hamiltonian Monte Carlo
# ---------------------------------------------------------------------------


class HMCResult(NamedTuple):
    samples: Optional[torch.Tensor]  # collected values, leading axis n_keep
    step_size: torch.Tensor  # final step size (0-d)
    accept_rate: torch.Tensor  # mean acceptance over the kept steps (0-d)


def _value_and_grad(log_prob_fn, state, generator):
    """``(log_prob(state), d sum(log_prob) / d state)``, both detached."""
    with torch.enable_grad():
        s = state.detach().requires_grad_(True)
        logp = log_prob_fn(s, generator)
        (grad,) = torch.autograd.grad(logp.sum(), s)
    return logp.detach(), grad


def _leapfrog(value_and_grad_fn, state, momentum, grad, step_size, num_steps: int, generator):
    """``num_steps`` leapfrog steps, each a half kick, a drift and a half
    kick; ``grad`` is the gradient at ``state``.  Returns ``(state,
    momentum, logp, grad)`` at the end point: each drift's target value and
    gradient come from one evaluation, which the next step's first half
    kick reuses."""
    logp = None
    for _ in range(num_steps):
        momentum = momentum + 0.5 * step_size * grad
        state = state + step_size * momentum
        logp, grad = value_and_grad_fn(state, generator)
        momentum = momentum + 0.5 * step_size * grad
    return state, momentum, logp, grad


def _metropolis_accept(generator, state, logp, new_state, new_logp, momentum, new_momentum):
    """The HMC accept test per chain: draws the uniforms, returns ``(accept,
    log_accept_ratio, state, logp)`` with the accepted chains moved."""
    ke_old = 0.5 * torch.sum(momentum**2, dim=-1)
    ke_new = 0.5 * torch.sum(new_momentum**2, dim=-1)
    log_accept_ratio = (new_logp - ke_new) - (logp - ke_old)
    u = _rand_rows(logp, generator)
    accept = torch.log(u) < log_accept_ratio
    state = torch.where(accept[..., None], new_state, state)
    logp = torch.where(accept, new_logp, logp)
    return accept, log_accept_ratio, state, logp


def _adapt_step_size(step_size, log_accept_ratio, t: int, n_adapt: int, target_accept: float,
                     adaptation_rate: float):
    """Scalar step-size adaptation toward the target acceptance (the
    SimpleStepSizeAdaptation recipe): one multiplicative nudge per step
    while ``t < n_adapt``.  The float32 step size goes down by a product
    with the float32 reciprocal of ``1 + adaptation_rate``, which is what
    XLA makes of the JAX package's division by that constant in its jitted
    chain (a true division differs in the last bit about a quarter of the
    time)."""
    if t >= n_adapt:
        return step_size
    accept_prob = rows_mod.mean(torch.exp(torch.clamp_max(log_accept_ratio, 0.0)))
    down = float(np.float32(1.0) / np.float32(1.0 + adaptation_rate))
    return torch.where(accept_prob > target_accept, step_size * (1.0 + adaptation_rate),
                       step_size * down)


def _momentum(state, generator):
    return _randn_rows(state, generator)


def _hmc_step(carry, generator, value_and_grad_fn, num_leapfrog: int, target_accept: float,
              n_adapt: int, adaptation_rate: float):
    """One HMC step on a deterministic target.  ``carry = (state, logp,
    grad, step_size, t)``: the current state's target value and gradient
    are carried, so a step costs ``num_leapfrog`` evaluations; ``t`` is a
    host int.  Returns ``(carry, accept)``."""
    state, logp, grad, step_size, t = carry
    momentum = _momentum(state, generator)
    new_state, new_momentum, new_logp, new_grad = _leapfrog(
        value_and_grad_fn, state, momentum, grad, step_size, num_leapfrog, generator)
    accept, log_accept_ratio, state, logp = _metropolis_accept(
        generator, state, logp, new_state, new_logp, momentum, new_momentum)
    grad = torch.where(accept[..., None], new_grad, grad)
    step_size = _adapt_step_size(step_size, log_accept_ratio, t, n_adapt, target_accept,
                                 adaptation_rate)
    return (state, logp, grad, step_size, t + 1), accept


def _hmc_step_stochastic(carry, generator, log_prob_fn, noise, num_leapfrog: int,
                         target_accept: float, n_adapt: int, adaptation_rate: float):
    """One HMC step on a stochastic target ``log_prob_fn(state, draws)``,
    with JAX's law (``bayesgm_tpu/ops/mcmc.py`` ``_hmc_step``): after the
    momentum, one draw ``noise(generator)`` is shared by every gradient of
    the step's leapfrog (``num_leapfrog + 1`` evaluations: the current
    state's carried value came from another draw, so its gradient is taken
    again), then an independent draw values the end point (no autograd),
    then the uniforms.  ``carry = (state, logp, step_size, t)``: the current
    state's value is carried from the step that reached it.  Returns
    ``(carry, accept)``."""
    state, logp, step_size, t = carry
    momentum = _momentum(state, generator)
    d_grad = noise(generator)
    value_and_grad_fn = partial(_value_and_grad, lambda s, g: log_prob_fn(s, d_grad))
    _, grad = value_and_grad_fn(state, generator)
    new_state, new_momentum, _, _ = _leapfrog(
        value_and_grad_fn, state, momentum, grad, step_size, num_leapfrog, generator)
    d_lp = noise(generator)
    with torch.no_grad():
        new_logp = log_prob_fn(new_state, d_lp)
    accept, log_accept_ratio, state, logp = _metropolis_accept(
        generator, state, logp, new_state, new_logp, momentum, new_momentum)
    step_size = _adapt_step_size(step_size, log_accept_ratio, t, n_adapt, target_accept,
                                 adaptation_rate)
    return (state, logp, step_size, t + 1), accept


def hmc(log_prob_fn: Callable, init_state, generator: torch.Generator, *, burn_in: int = 5000,
        n_keep: int = 3000, step_size: float = 0.01, num_leapfrog: int = 10,
        target_accept: float = 0.75, adapt_fraction: float = 0.8,
        adaptation_rate: float = 0.01, collect: Optional[Callable] = None,
        params=None, noise: Optional[Callable] = None, mesh=None) -> HMCResult:
    """HMC over ``n`` independent chains (axis 0 of ``init_state``), with
    the step size adapted toward ``target_accept`` over the first
    ``int(burn_in * adapt_fraction)`` steps (times ``1 + adaptation_rate``
    when the step's mean acceptance probability is above it, divided by it
    otherwise).

    Without ``noise``, ``log_prob_fn(state, g) -> (n,)`` must be
    differentiable in ``state`` and a deterministic function of it: the
    value and gradient at the current state are carried from the step that
    reached it, where the JAX package evaluates them again (the same
    numbers), so a step costs ``num_leapfrog`` evaluations.  With
    ``noise(g) -> draws`` the target is stochastic, ``log_prob_fn(state,
    draws)``: see :func:`_hmc_step_stochastic` (``num_leapfrog + 1``
    gradients and one value per step; the initial value under a draw of its
    own).  With ``params`` given, ``log_prob_fn`` and ``collect`` take
    ``params`` first.  ``collect(state, g)`` is the per-kept-step statistic
    (the raw state by default); ``samples`` stacks it along a leading
    ``n_keep`` axis (None when ``n_keep == 0``).  The step size and the
    acceptance sum stay on the device: a step reads nothing back to the
    host.  Each step draws the momentum, then (through the target) the
    evaluations, then the accept uniforms, then the collected statistic.
    ``mesh``: the rows of ``init_state`` are this rank's chains (see the
    module docstring); the accept probability and the acceptance mean are
    over every rank's chains."""
    if num_leapfrog < 1:
        raise ValueError(f"num_leapfrog must be at least 1, got {num_leapfrog}")
    with rows_mod.split(_row_split(mesh, init_state)):
        return _hmc(log_prob_fn, init_state, generator, burn_in, n_keep, step_size,
                    num_leapfrog, target_accept, adapt_fraction, adaptation_rate, collect,
                    params, noise)


def _hmc(log_prob_fn, init_state, generator, burn_in, n_keep, step_size, num_leapfrog,
         target_accept, adapt_fraction, adaptation_rate, collect, params, noise):
    if params is None:
        lp, col = log_prob_fn, collect
    else:
        lp = lambda s, g: log_prob_fn(params, s, g)
        col = None if collect is None else (lambda s, g: collect(params, s, g))
    collect_fn = (lambda s, g: s) if col is None else col
    kw = dict(num_leapfrog=num_leapfrog, target_accept=target_accept,
              n_adapt=int(burn_in * adapt_fraction), adaptation_rate=adaptation_rate)

    dev = init_state.device
    step0 = torch.tensor(step_size, dtype=torch.float32, device=dev)
    if noise is None:
        step = partial(_hmc_step, value_and_grad_fn=partial(_value_and_grad, lp), **kw)
        logp0, grad0 = _value_and_grad(lp, init_state, generator)
        carry = (init_state.detach(), logp0, grad0, step0, 0)
    else:
        step = partial(_hmc_step_stochastic, log_prob_fn=lp, noise=noise, **kw)
        with torch.no_grad():
            logp0 = lp(init_state, noise(generator))
        carry = (init_state.detach(), logp0, step0, 0)
    for _ in range(burn_in):
        carry, _ = step(carry, generator)
    samples = []
    acc_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(n_keep):
        carry, accept = step(carry, generator)
        acc_sum = acc_sum + rows_mod.partial_mean(accept.to(torch.float32))
        samples.append(collect_fn(carry[0], generator))
    stacked = torch.stack(samples) if samples else None
    return HMCResult(samples=stacked, step_size=carry[-2],
                     accept_rate=rows_mod.total(acc_sum) / max(n_keep, 1))


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
