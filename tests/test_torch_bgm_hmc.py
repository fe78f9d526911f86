"""BGM's HMC imputation against the JAX package's: one ``_hmc_step`` on the
masked target with the same momentum, uniforms and (flipout decoder) weight
noise in each mode — deterministic (value and gradient carried) and
stochastic (one draw shared by a step's leapfrog gradients, another for the
end point's value) — then ``predict`` in law on bridged nets, the ragged
pattern's intervals and subject batching."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import bgm as jbgm  # noqa: E402
from bayesgm_tpu.ops import distributions as jdist  # noqa: E402
from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch.models import bgm as tbgm  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402

from _torch_parity import FlipoutDraws, flipout_draw  # noqa: E402
from test_torch_bgm import _bridged, _low_rank  # noqa: E402

torch.set_num_threads(2)

# f32 arithmetic of three leapfrog steps through the decoder's forward and
# backward, summed in another order than XLA's
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
N_ROWS, LEAPFROG = 12, 3


def _keyed_jax_draws(monkeypatch):
    """JAX's flipout draws keyed by the PRNG key: every call under one key
    gets the same draw of the shared stream, the i-th distinct key draw i."""
    seen = {}

    def draws(key, layers, batch):
        i = seen.setdefault(np.asarray(key).tobytes(), len(seen))
        dims = [tuple(p["loc"].shape) for p in layers]
        return tuple([jnp.asarray(a) for a in part] for part in flipout_draw(i, dims, int(batch)))

    monkeypatch.setattr(jnn, "_fused_flipout_draws", draws)
    return seen


@pytest.mark.parametrize("t,use_bnn", [(0, False), (10, False), (0, True), (10, True)],
                         ids=["deterministic-adapting", "deterministic-adapted",
                              "stochastic-adapting", "stochastic-adapted"])
def test_hmc_step_matches_jax(tmp_path, monkeypatch, t, use_bnn):
    """One HMC step on BGM's masked target (a ragged observed pattern),
    with the momentum and uniforms injected on both sides.  Plain decoder:
    the port's deterministic step (value and gradient carried) against
    JAX's.  Flipout decoder: the port's stochastic step against JAX's with
    its flipout draws keyed by the PRNG key, so that every gradient under
    ``k_grad`` shares one draw and the value under ``k_lp`` takes the next,
    the draws the port's ``noise`` gives in that order; the port evaluates
    the target ``num_leapfrog + 2`` times (``num_leapfrog + 1`` gradients,
    one value)."""
    ports = FlipoutDraws(monkeypatch)
    keyed = _keyed_jax_draws(monkeypatch)
    jm, tm = _bridged(tmp_path, use_bnn=use_bnn, x_dim=4)
    rng = np.random.default_rng(0)
    data = _low_rank(N_ROWS)
    observed = rng.random(data.shape) > 0.3
    ind = [np.where(row)[0].tolist() for row in observed]
    mask = tm._prep_obs_dense_mask(data, ind, 4)
    state = rng.normal(size=(N_ROWS, 2)).astype(np.float32)
    mom = rng.normal(size=(N_ROWS, 2)).astype(np.float32)
    unif = np.where(np.arange(N_ROWS) % 2 == 0, 1e-6, 0.9).astype(np.float32)
    logp0 = rng.normal(-20.0, 1.0, N_ROWS).astype(np.float32)  # a carried value
    kw = dict(num_leapfrog=LEAPFROG, target_accept=0.75, n_adapt=10, adaptation_rate=0.05)

    j_data, j_mask = jnp.asarray(data), jnp.asarray(mask.numpy())

    def j_lp(z, key):
        mu, s, _ = jbgm._g_apply(jm.cfg, jm.nets["g"], jm.g_state, z, key, train=False)
        ll = ((j_data - mu) ** 2 / (2.0 * s) + 0.5 * jnp.log(s)) * j_mask
        return -(jdist.standard_normal_neg_log_prior(z) + jnp.sum(ll, axis=1))

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(mom))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(unif))
        (js, jl, jstep, _), (jacc, _) = jmcmc._hmc_step(
            (jnp.asarray(state), jnp.asarray(logp0), jnp.float32(0.3), jnp.int32(t)),
            jax.random.PRNGKey(0), log_prob_fn=j_lp,
            grad_fn=jax.grad(lambda s, k: jnp.sum(j_lp(s, k))), **kw)

    calls = []
    t_data, g = torch.as_tensor(data), tm.nets["g"]

    def t_lp(z, draws_or_gen):
        calls.append(z.requires_grad)
        kw_ = dict(draws=draws_or_gen) if use_bnn else dict(generator=draws_or_gen)
        return tbgm._masked_log_prob(tm.cfg, g, z, t_data, mask, **kw_)

    t_state = torch.as_tensor(state)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(mom))
        mp.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(unif))
        if use_bnn:
            noise = lambda gen: tnn._fused_flipout_draws(g.layers(), (N_ROWS, 2), gen)
            (ts, tl, tstep, tt), tacc = tmcmc._hmc_step_stochastic(
                (t_state, torch.as_tensor(logp0), torch.tensor(0.3), t), None,
                log_prob_fn=t_lp, noise=noise, **kw)
            assert len(keyed) == ports.port_calls == 2
            assert calls == [True] * (LEAPFROG + 1) + [False]
        else:
            _, grad0 = tmcmc._value_and_grad(t_lp, t_state, None)
            (ts, tl, _, tstep, tt), tacc = tmcmc._hmc_step(
                (t_state, torch.as_tensor(logp0), grad0, torch.tensor(0.3), t), None,
                value_and_grad_fn=lambda s, gen: tmcmc._value_and_grad(t_lp, s, gen), **kw)
            assert len(calls) == 1 + LEAPFROG
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < int(tacc.sum()) < N_ROWS
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STEP_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-7)
    assert tt == t + 1


def test_stochastic_chain_counts_its_evaluations(tmp_path):
    """Through tfp_mcmc_sampler with the flipout decoder: one value for the
    initial state, then num_leapfrog + 2 evaluations and two noise draws
    per step; the plain decoder takes num_leapfrog evaluations per step
    after one value-and-gradient."""
    for use_bnn, per_step in ((True, LEAPFROG + 2), (False, LEAPFROG)):
        (tmp_path / str(use_bnn)).mkdir()
        _, tm = _bridged(tmp_path / str(use_bnn), use_bnn=use_bnn, x_dim=4)
        calls, hmc = [], tmcmc.hmc

        def counting(log_prob_fn, *a, **kw):
            return hmc(lambda p, z, d: calls.append(1) or log_prob_fn(p, z, d), *a, **kw)

        tmcmc.hmc = counting
        try:
            z = tm.tfp_mcmc_sampler(_low_rank(6), n_mcmc=4, burn_in=3,
                                    num_leapfrog_steps=LEAPFROG)
        finally:
            tmcmc.hmc = hmc
        assert z.shape == (4, 6, 2) and np.all(np.isfinite(z))
        assert len(calls) == 1 + 7 * per_step


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_predict_matches_jax_in_law(tmp_path, use_bnn):
    """Same bridged nets, the same rows with column 0 hidden: each imputed
    mean within 4 Monte-Carlo standard errors of JAX's (se = sd of the draws
    over sqrt(ESS), from each package's own diagnostics); observed entries
    passed through; intervals of the same shape."""
    jm, tm = _bridged(tmp_path, use_bnn=use_bnn, x_dim=4)
    test = _low_rank(12)
    test[:, 0] = np.nan
    kw = dict(alpha=0.1, n_mcmc=400, burn_in=200, step_size=0.1, num_leapfrog_steps=5,
              return_samples=True, return_diagnostics=True)
    cube_j, iv_j, diag_j = jm.predict(test, **kw)
    cube_t, iv_t, diag_t = tm.predict(test, **kw)
    cube_j = np.asarray(cube_j)
    assert cube_t.shape == cube_j.shape == (400, 12, 4)
    assert iv_t.shape == np.asarray(iv_j).shape == (12, 1, 2)
    np.testing.assert_array_equal(np.isnan(diag_t["ess"]), np.isnan(np.asarray(diag_j["ess"])))
    se = lambda cube, diag: cube[:, :, 0].std(axis=0) / np.sqrt(diag["ess"][:, 0])
    bound = 4.0 * np.sqrt(se(cube_t, diag_t) ** 2 + se(cube_j, diag_j) ** 2)
    gap = np.abs(cube_t[:, :, 0].mean(axis=0) - cube_j[:, :, 0].mean(axis=0))
    assert np.all(gap <= bound), (gap, bound)
    imputed, iv = tm.predict(test, alpha=0.1, n_mcmc=20, burn_in=10)
    np.testing.assert_array_equal(imputed[:, 1:], test[:, 1:])
    assert np.all(np.isfinite(imputed)) and np.all(iv[:, 0, 0] <= iv[:, 0, 1])


def test_ragged_pattern_intervals_match_jaxs_shapes(tmp_path):
    """A ragged missing pattern gives a list of per-row intervals, shaped as
    JAX's (tests/test_models.py::test_bgm_ragged_missing_pattern), and the
    diagnostics are NaN exactly at the observed entries."""
    jm, tm = _bridged(tmp_path, x_dim=4)
    test = _low_rank(6)
    test[0, 1] = np.nan
    test[2, 2] = test[2, 3] = np.nan
    _, iv_j = jm.predict(test, n_mcmc=10, burn_in=10)
    imputed, iv_t, diag = tm.predict(test, n_mcmc=10, burn_in=10, return_diagnostics=True)
    assert isinstance(iv_t, list) and [a.shape for a in iv_t] == [a.shape for a in iv_j]
    assert [a.shape for a in iv_t[:3]] == [(1, 2), (0, 2), (2, 2)]
    np.testing.assert_array_equal(np.isnan(diag["ess"]), ~np.isnan(test))
    assert not np.any(np.isnan(imputed))


def test_predict_batching_and_the_cube_budget(tmp_path):
    """_resolve_impute_bs as JAX's (tests/test_predict_batching.py); an
    explicit bs splits the subjects (one chain per batch) and leaves the
    observed entries and the shapes as one batch does."""
    _, tm = _bridged(tmp_path, x_dim=4)
    jm = jbgm.BGM(dict(x_dim=20, z_dim=4, dataset="rb", output_dir=str(tmp_path / "rb"),
                       save_res=False, save_model=False), random_seed=0)
    for args in ((None, 2000, 5000, 20), (None, 10**6, 5000, 784), (100, 2000, 5000, 20),
                 (0, 10, 10, 4)):
        assert tm._resolve_impute_bs(*args) == jm._resolve_impute_bs(*args)
    assert tm._resolve_impute_bs(None, 10**6, 5000, 784) == (2 * 2**30) // (5000 * 784 * 4)
    test = _low_rank(10)
    test[:, 0] = np.nan
    calls = []
    sampler = tm.tfp_mcmc_sampler
    tm.tfp_mcmc_sampler = lambda data, **kw: calls.append(len(data)) or sampler(data, **kw)
    one, iv_one = tm.predict(test, bs=1000, n_mcmc=20, burn_in=20)
    cube, iv_bat = tm.predict(test, bs=3, n_mcmc=20, burn_in=20, return_samples=True)
    assert calls == [10, 3, 3, 3, 1]
    assert cube.shape == (20, 10, 4) and iv_one.shape == iv_bat.shape == (10, 1, 2)
    np.testing.assert_array_equal(one[:, 1:], test[:, 1:])
