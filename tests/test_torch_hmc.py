"""The port's weight-space sampler, ``ops.mcmc.hmc``, against the JAX
package's: one ``_hmc_step`` with the same injected momentum and accept
uniforms gives the same state, log target, acceptance and adapted step
size, and the chain-level cases of ``tests/test_mcmc.py`` (a shifted normal
recovered, the step size adapting up, params mode equal to closure mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

torch.set_num_threads(2)

# f32 arithmetic of three leapfrog steps through tanh, summed in another
# order than XLA's
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _j_logp(s, key):
    return -0.5 * jnp.sum(s**2, axis=-1) - jnp.sum(jnp.log(jnp.cosh(1.5 * s - 0.3)), axis=-1)


def _t_logp(s, generator):
    return -0.5 * torch.sum(s**2, dim=-1) - torch.sum(torch.log(torch.cosh(1.5 * s - 0.3)), dim=-1)


@pytest.mark.parametrize("t,n_adapt", [(0, 10), (10, 10)], ids=["adapting", "adapted"])
def test_hmc_step_matches_jax_with_injected_draws(monkeypatch, t, n_adapt):
    """The same momentum (N(0, I)) and uniforms on both sides; the port
    carries the current gradient, JAX evaluates it again (same numbers).
    Uniforms chosen so some chains accept and some reject."""
    rng = np.random.default_rng(0)
    state = rng.normal(size=(16, 3)).astype(np.float32)
    mom = rng.normal(size=(16, 3)).astype(np.float32)
    unif = np.where(np.arange(16) % 2 == 0, 1e-6, 0.999).astype(np.float32)
    kw = dict(num_leapfrog=3, target_accept=0.75, n_adapt=n_adapt, adaptation_rate=0.05)

    j_state = jnp.asarray(state)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(mom))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(unif))
        (js, jl, jstep, jt), (jacc, _) = jmcmc._hmc_step(
            (j_state, _j_logp(j_state, None), jnp.float32(0.4), jnp.int32(t)),
            jax.random.PRNGKey(0), log_prob_fn=_j_logp,
            grad_fn=jax.grad(lambda s, k: jnp.sum(_j_logp(s, k))), **kw)

    t_state = torch.as_tensor(state)
    logp0, grad0 = tmcmc._value_and_grad(_t_logp, t_state, None)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(mom))
        mp.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(unif))
        (ts, tl, tg, tstep, tt), tacc = tmcmc._hmc_step(
            (t_state, logp0, grad0, torch.tensor(0.4), t), None,
            value_and_grad_fn=lambda s, g: tmcmc._value_and_grad(_t_logp, s, g), **kw)

    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < int(tacc.sum()) < 16
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STEP_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-7)
    assert tt == int(jt) == t + 1
    # the carried gradient is the gradient at the carried state
    np.testing.assert_allclose(tg.numpy(), tmcmc._value_and_grad(_t_logp, ts, None)[1].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_hmc_recovers_shifted_normal():
    """tests/test_mcmc.py::test_hmc_recovers_shifted_normal, same settings
    and limits."""
    mu = torch.tensor([1.5, -0.5])
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum((z - mu) ** 2, dim=-1), torch.zeros((32, 2)),
                    torch.Generator().manual_seed(0), burn_in=300, n_keep=1000, step_size=0.2,
                    num_leapfrog=5)
    samples = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), mu.numpy(), atol=0.12)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12)
    assert float(res.accept_rate) > 0.5


def test_hmc_step_size_adapts_up():
    """tests/test_mcmc.py::test_hmc_step_size_adapts_up."""
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum(z**2, dim=-1), torch.zeros((8, 2)),
                    torch.Generator().manual_seed(1), burn_in=500, n_keep=50, step_size=0.001,
                    num_leapfrog=3)
    assert float(res.step_size) > 0.001


def test_hmc_params_mode_matches_closure_mode():
    """tests/test_mcmc.py::test_hmc_params_mode_matches_closure_mode: the
    same draws bit for bit, and params reach the target and the collector."""
    def lp(params, s, g):
        return -0.5 * torch.sum((s - params["mu"]) ** 2, dim=-1)

    init = torch.randn((8, 2), generator=torch.Generator().manual_seed(8))
    params = {"mu": torch.ones(2)}
    kw = dict(burn_in=100, n_keep=50, step_size=0.2, num_leapfrog=3)
    r_p = tmcmc.hmc(lp, init, torch.Generator().manual_seed(9), params=params, **kw)
    r_c = tmcmc.hmc(lambda s, g: lp(params, s, g), init, torch.Generator().manual_seed(9), **kw)
    assert torch.equal(r_p.samples, r_c.samples)
    assert torch.equal(r_p.step_size, r_c.step_size)
    r2 = tmcmc.hmc(lp, init, torch.Generator().manual_seed(9), params={"mu": 4.0 * torch.ones(2)},
                   collect=lambda p, s, g: s.mean(dim=0) - p["mu"], **kw)
    assert r2.samples.shape == (50, 2)
    assert abs(float(r2.samples.mean())) < 1.0


def test_hmc_shapes_and_refusals():
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum(z**2, dim=-1), torch.zeros((3, 4)),
                    torch.Generator().manual_seed(2), burn_in=5, n_keep=0, num_leapfrog=2)
    assert res.samples is None and float(res.accept_rate) == 0.0
    with pytest.raises(ValueError, match="num_leapfrog"):
        tmcmc.hmc(lambda z, g: -z.sum(dim=-1), torch.zeros((3, 4)), torch.Generator(),
                  burn_in=1, n_keep=1, num_leapfrog=0)
