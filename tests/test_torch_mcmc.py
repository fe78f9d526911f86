"""The port's adaptive MH (per step and in windows) and MALA and chain
diagnostics: analytic Gaussian targets, the adaptation schedules and the
window's bookkeeping against JAX's, and ESS / split-R̂ against the JAX
functions on the same draws."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

torch.set_num_threads(2)

MU = torch.tensor([1.0, -2.0])
SD = torch.tensor([0.5, 2.0])


def _gauss_lp(p, s, g):
    return -0.5 * torch.sum(((s - MU) / SD) ** 2, dim=1)


def _run(seed, paired=False, q_sd=1.0, adaptive=True, burn_in=600, n_keep=1500,
         n_chains=256):
    gen = torch.Generator().manual_seed(seed)
    init = torch.randn((n_chains, 2), generator=gen)
    plp = (lambda p, a, b, g: (_gauss_lp(p, a, g), _gauss_lp(p, b, g))) if paired else None
    return tmcmc.adaptive_mh(_gauss_lp, init, gen, burn_in=burn_in, n_keep=n_keep,
                             q_sd=q_sd, adaptive=adaptive, recompute_current=True,
                             paired_log_prob_fn=plp)


def _moments_within_mc_error(draws, mu, var):
    """Pooled mean and variance within 5 Monte-Carlo standard errors, the
    error sized by the per-chain ESS."""
    x = draws.numpy()  # (n_keep, n_chains, d)
    ess = tmcmc.effective_sample_size(x).sum(axis=0)  # (d,) over independent chains
    mean, v = x.reshape(-1, 2).mean(axis=0), x.reshape(-1, 2).var(axis=0)
    se_mean = np.sqrt(var / ess)
    se_var = var * np.sqrt(2.0 / ess)
    assert np.all(np.abs(mean - mu) < 5 * se_mean), (mean, mu, se_mean)
    assert np.all(np.abs(v - var) < 5 * se_var), (v, var, se_var)


def test_gaussian_target_moments():
    res = _run(0)
    assert tuple(res.samples.shape) == (1500, 256, 2)
    _moments_within_mc_error(res.samples, MU.numpy(), (SD**2).numpy())


def test_adaptation_brings_rate_into_band():
    res = _run(1, q_sd=8.0, burn_in=1000, n_keep=200)
    assert float(res.q_sd) < 8.0
    assert abs(float(res.accept_rate) - 0.25) <= 0.05


def test_paired_and_unpaired_recompute_agree_in_law():
    a = _run(2, paired=False).samples.numpy().reshape(-1, 2)
    b = _run(3, paired=True).samples.numpy().reshape(-1, 2)
    # both against the truth, and against each other (loose: chains autocorrelate)
    _moments_within_mc_error(torch.as_tensor(b.reshape(1500, 256, 2)), MU.numpy(),
                             (SD**2).numpy())
    np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), atol=0.1)
    np.testing.assert_allclose(a.var(axis=0), b.var(axis=0), rtol=0.1)


def test_adaptation_fires_on_the_same_steps_as_jax():
    """Scripted acceptance (a per-step fraction of rows accepts): the q_sd
    trajectory of the port's _mh_step equals JAX's step for step."""
    n, steps = 64, 320
    statics = dict(q_sd_is_adaptive=True, burn_in=260, target_rate=0.25, tolerance=0.05,
                   adjustment_interval=50, window_size=100, recompute_current=False)
    fracs = np.random.default_rng(0).uniform(0.0, 0.6, size=steps)
    fracs[:120] = 0.05  # a low-acceptance run, then a mix

    def scripted(t):
        k = int(round(fracs[t] * n))
        return np.where(np.arange(n) < k, 0.0, -np.inf).astype(np.float32)

    j_carry = (jnp.zeros((n, 2)), jnp.zeros((n,)), jnp.float32(1.0),
               jnp.zeros((100,), jnp.float32), jnp.int32(0))
    t_carry = (torch.zeros((n, 2)), torch.zeros(n), torch.tensor(1.0),
               torch.zeros(100), 0)
    gen = torch.Generator().manual_seed(0)
    j_q, t_q = [], []
    for t in range(steps):
        lp_t = scripted(t)
        j_carry, _ = jmcmc._mh_step(j_carry, jax.random.PRNGKey(t),
                                    lambda s, k: jnp.asarray(lp_t), shared_eval_key=False,
                                    **statics)
        t_carry, _ = tmcmc._mh_step(t_carry, gen, lambda s, g: torch.as_tensor(lp_t),
                                    **statics)
        j_q.append(float(j_carry[2]))
        t_q.append(float(t_carry[2]))
    np.testing.assert_allclose(t_q, j_q, rtol=1e-6)
    assert len(set(np.round(t_q, 6))) > 3  # the schedule did fire, both ways


def test_diagnostics_equal_jax():
    rng = np.random.default_rng(0)
    x = np.zeros((400, 6))
    for t in range(1, 400):  # AR(1) with varying correlation per series
        x[t] = np.linspace(0.0, 0.9, 6) * x[t - 1] + rng.normal(size=6)
    x[:, 4] = 1.5  # constant series
    x[7, 5] = np.nan  # diverged series
    for fn in ("effective_sample_size", "split_rhat"):
        np.testing.assert_array_equal(getattr(tmcmc, fn)(x), getattr(jmcmc, fn)(x))
        np.testing.assert_array_equal(getattr(tmcmc, fn)(x.T, axis=1),
                                      getattr(jmcmc, fn)(x.T, axis=1))
    got = tmcmc.chain_diagnostics(x[:, :4], accept_rate=0.3)
    want = jmcmc.chain_diagnostics(x[:, :4], accept_rate=0.3)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_burn_in_only_returns_no_samples_and_collect_is_used():
    gen = torch.Generator().manual_seed(0)
    res = tmcmc.adaptive_mh(_gauss_lp, torch.zeros((8, 2)), gen, burn_in=20, n_keep=0)
    assert res.samples is None and 0.0 <= float(res.accept_rate) <= 1.0
    params = {"shift": torch.tensor(3.0)}
    res = tmcmc.adaptive_mh(_gauss_lp, torch.zeros((8, 2)), gen,
                            burn_in=5, n_keep=7, params=params,
                            collect=lambda p, s, g: s.mean(dim=0) + p["shift"])
    assert tuple(res.samples.shape) == (7, 2)


# -- the MH window (multi_step_fn) ----------------------------------------------


def _plain_multi_step(lp_fn, K):
    """Plain stand-in for the K-step MH window kernel (the JAX test's)."""
    def window(params, state, q_sd, g):
        counts = torch.zeros(K)
        for i in range(K):
            prop = state + q_sd * torch.randn(state.shape, generator=g)
            lp_p, lp_c = lp_fn(params, prop, g), lp_fn(params, state, g)
            acc = torch.log(torch.rand(lp_p.shape, generator=g)) < lp_p - lp_c
            state = torch.where(acc[:, None], prop, state)
            counts[i] = acc.sum()
        return state, lp_fn(params, state, g), counts
    return window


def _std_normal_p(p, s, g):
    return -0.5 * torch.sum(s**2, dim=1)


def test_adaptive_mh_multi_step_burn_recovers_target():
    """Window burn-in + per-step sampling recovers N(0, I) (as the JAX
    package's test: 64 chains, 500 burn-in steps in windows of 50, 1500 kept)."""
    gen = torch.Generator().manual_seed(10)
    res = tmcmc.adaptive_mh(_std_normal_p, torch.zeros((64, 3)), gen, burn_in=500,
                            n_keep=1500, q_sd=1.0, adaptive=True, recompute_current=True,
                            params={}, multi_step_fn=_plain_multi_step(_std_normal_p, 50))
    samples = res.samples.numpy().reshape(-1, 3)
    np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=0.12)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12)


def test_adaptive_mh_multi_step_adapts_q_sd():
    """Adaptation fires between windows: a tight target shrinks q_sd."""
    lp = lambda p, s, g: -0.5 * torch.sum((s / 0.01) ** 2, dim=1)
    res = tmcmc.adaptive_mh(lp, torch.zeros((16, 2)), torch.Generator().manual_seed(11),
                            burn_in=1000, n_keep=50, q_sd=1.0, adaptive=True,
                            recompute_current=True, params={},
                            multi_step_fn=_plain_multi_step(lp, 50))
    assert float(res.q_sd) < 0.5


def test_window_bookkeeping_equals_jax(monkeypatch):
    """Both packages' adaptive_mh drive a window that ignores its key and
    returns scripted per-step accept counts (window w reads row w of a table,
    counted in the state): the q_sd each window gets, the final q_sd, the
    acceptance ring and the returned rate are equal."""
    n, K, n_windows = 64, 50, 12
    table = np.random.default_rng(3).integers(0, 40, size=(n_windows, K)).astype(np.float32)
    table[:3] = 5.0  # low acceptance first, then a mix

    j_q, j_rings = [], []
    jax_dus = jax.lax.dynamic_update_slice

    def recording_dus(operand, update, idx):
        out = jax_dus(operand, update, idx)
        if operand.shape == (100,):
            jax.debug.callback(lambda r: j_rings.append(np.asarray(r)), out)
        return out

    def j_window(params, state, q_sd, key):
        jax.debug.callback(lambda q: j_q.append(float(q)), q_sd)
        counts = jnp.take(jnp.asarray(table), state[0, 0].astype(jnp.int32), axis=0)
        return state + 1.0, jnp.zeros(state.shape[0]), counts

    monkeypatch.setattr(jax.lax, "dynamic_update_slice", recording_dus)
    j_res = jmcmc.adaptive_mh(lambda p, s, k: jnp.zeros(s.shape[0]), jnp.zeros((n, 2)),
                              jax.random.PRNGKey(0), burn_in=K * n_windows, n_keep=0,
                              q_sd=1.0, recompute_current=True, params={},
                              multi_step_fn=j_window)
    monkeypatch.setattr(jax.lax, "dynamic_update_slice", jax_dus)

    t_q, t_rings = [], []
    burn = tmcmc._window_burn_in

    def recording_burn(*a, **kw):
        carry, rate = burn(*a, **kw)
        t_rings.append(carry[3].clone())
        return carry, rate

    def t_window(params, state, q_sd, g):
        t_q.append(float(q_sd))
        return state + 1.0, torch.zeros(state.shape[0]), torch.as_tensor(table[int(state[0, 0])])

    monkeypatch.setattr(tmcmc, "_window_burn_in", recording_burn)
    t_res = tmcmc.adaptive_mh(lambda p, s, g: torch.zeros(s.shape[0]), torch.zeros((n, 2)),
                              torch.Generator().manual_seed(0), burn_in=K * n_windows,
                              n_keep=0, q_sd=1.0, recompute_current=True, params={},
                              multi_step_fn=t_window)
    assert len(t_q) == len(j_q) == n_windows and len(set(t_q)) > 3  # adaptation fired
    np.testing.assert_array_equal(np.float32(t_q), np.float32(j_q))
    assert float(t_res.q_sd) == float(j_res.q_sd)
    np.testing.assert_array_equal(t_rings[-1].numpy(), j_rings[-1])
    assert float(t_res.accept_rate) == float(j_res.accept_rate) == table[-1, -1] / n
    assert t_res.samples is None and j_res.samples is None


@pytest.mark.parametrize("kw", [dict(burn_in=75), dict(window_size=75),
                                dict(recompute_current=False)])
def test_window_only_when_the_cadences_align(kw):
    """burn_in or window_size not a multiple of adjustment_interval, or a
    deterministic target: the burn-in runs per step, as in JAX."""
    calls = []
    args = dict(burn_in=100, n_keep=3, recompute_current=True, params={})
    args.update(kw)
    res = tmcmc.adaptive_mh(_std_normal_p, torch.zeros((8, 2)), torch.Generator().manual_seed(0),
                            multi_step_fn=lambda *a: calls.append(1), **args)
    assert calls == [] and tuple(res.samples.shape) == (3, 8, 2)


# -- MALA ----------------------------------------------------------------------


def _std_normal_lp(s, g):
    return -0.5 * torch.sum(s**2, dim=1)


@pytest.mark.parametrize("recompute", [False, True])
def test_adaptive_mala_recovers_standard_normal(recompute):
    """As the JAX package's own MALA tests: the cached chain on the
    deterministic target, and the fresh-noise chain on a noisy unbiased
    estimate of it, both recover N(0, I)."""
    gen = torch.Generator().manual_seed(5)
    if recompute:
        def lp(s, g):  # unbiased jitter on the log-density, redrawn every call
            return _std_normal_lp(s, g) + 0.05 * torch.randn(s.shape[0], generator=g)
    else:
        lp = _std_normal_lp
    res = tmcmc.adaptive_mala(lp, torch.zeros((64, 3)), gen, burn_in=300, n_keep=1500,
                              step_size=0.5, recompute_current=recompute)
    samples = res.samples.numpy().reshape(-1, 3)
    np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12 if recompute else 0.1)
    assert (0.3 if recompute else 0.4) < float(res.accept_rate) <= 1.0
    assert float(res.q_sd) > 0.5  # high acceptance: the step size grew in burn-in


@pytest.mark.parametrize("recompute,calls", [(False, 1 + 30), (True, 2 * 30)])
def test_adaptive_mala_evaluations_per_step(recompute, calls):
    """The cached chain evaluates the target once up front and once per
    step, the fresh-noise chain twice per step; collect sees every kept
    state."""
    seen = []

    def lp(s, g):
        seen.append(s.shape)
        return _std_normal_lp(s, g)

    res = tmcmc.adaptive_mala(lp, torch.zeros((8, 2)), torch.Generator().manual_seed(0),
                              burn_in=10, n_keep=20, recompute_current=recompute,
                              collect=lambda s, g: s.mean(dim=0))
    assert len(seen) == calls and tuple(res.samples.shape) == (20, 2)
    assert res.q_sd.ndim == 0


def test_mala_adaptation_fires_on_the_same_steps_as_jax():
    """Scripted acceptance (zero gradient, so the proposal is symmetric, and
    a per-step fraction of rows proposing logp 0 against -inf): the step-size
    trajectory of the port's cached MALA step equals JAX's step for step."""
    n, steps = 64, 320
    fracs = np.random.default_rng(1).uniform(0.3, 0.9, size=steps)
    fracs[:120] = 0.95

    def scripted(t):
        k = int(round(fracs[t] * n))
        return np.where(np.arange(n) < k, 0.0, -np.inf).astype(np.float32)

    statics = dict(burn_in=260, target_rate=0.574, tolerance=0.05, adjustment_interval=50)
    j_carry = (jnp.zeros((n, 2)), jnp.zeros((n,)), jnp.zeros((n, 2)), jnp.float32(0.1),
               jnp.zeros((100,), jnp.float32), jnp.int32(0))
    t_carry = (torch.zeros((n, 2)), torch.zeros(n), torch.zeros((n, 2)), torch.tensor(0.1),
               torch.zeros(100), 0)
    adapt = partial(tmcmc._adapt, adaptive=True, **statics)
    gen = torch.Generator().manual_seed(0)
    j_eps, t_eps = [], []
    for t in range(steps):
        lp_t = scripted(t)
        j_carry, _ = jmcmc._mala_step(
            j_carry, jax.random.PRNGKey(t),
            lambda s, k: (jnp.asarray(lp_t), jnp.zeros_like(s)),
            adaptive=jnp.asarray(True), window_size=100, **statics)
        t_carry, _ = tmcmc._mala_step(
            t_carry, gen, lambda s, g: (torch.as_tensor(lp_t), torch.zeros_like(s)), adapt,
            100)
        j_eps.append(float(j_carry[3]))
        t_eps.append(float(t_carry[3]))
    np.testing.assert_allclose(t_eps, j_eps, rtol=1e-6)
    assert len(set(np.round(t_eps, 6))) > 3  # the schedule did fire, both ways
